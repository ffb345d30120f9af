"""Masked segment reductions and graph pooling (counterpart of
``gsn_tpu/ops/segment.py``).

``global_add_pool`` / ``global_mean_pool`` and the virtual node's
``broadcast_graph_to_nodes`` route through the pool kernels
(``ops/cuda/slab_pool.py``) over the batch's ``graph_ptr``.  Receiver
sums of per-edge rows (the mean aggregation, the DGN ``var``/``std``
aggregators and softmax weights) are K3 over the batch's ``recv_ptr``
(``receiver_sum`` / ``receiver_mean``): the real edges are stably
receiver-sorted, padding edges last, so each receiver's rows are summed
in one fixed order, as the reference's ``jax.ops.segment_sum`` is on its
chip.  The masked ``index_add`` sums serve only callers that have no
segment layout.

The per-edge gathers of node rows (``receiver_gather`` /
``sender_gather``: ``A[recv]``, ``B[send]`` over every edge slot) have
the same sums as their backward: K3 over ``recv_ptr``, and over
``send_ptr`` through the sender-sorted ``send_perm``, in place of the
sorted ``index_put_`` of ``x[idx]``'s backward, which walks the padding
slots (all at node slot 0) as one serial run.

Under edge partitioning (``axis``: the mesh axis of the node blocks) a
pool sums its block's partial per-graph sums, and its node counts, over
the ranks (``gsn_tpu/ops/segment.py:100-140``): a graph whose nodes lie
in two blocks gets each block's part once.
"""

from __future__ import annotations

from typing import Optional

import torch

from gsn_tpu_torch.parallel.collectives import all_reduce
from .cuda.slab_combine import segment_sum_sorted
from .cuda.slab_message import EdgeSegments
from .cuda.slab_pool import add_pool, graph_broadcast


def masked_segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Segment-sum with optional row mask (padding rows contribute 0)."""
    if mask is not None:
        data = torch.where(mask.reshape((-1,) + (1,) * (data.dim() - 1)),
                           data, torch.zeros_like(data))
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    return out.index_add(0, segment_ids, data)


def masked_segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                        num_segments: int,
                        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean with zero-guard on empty segments (reference
    ``degrees[degrees==0]=1`` at ``GSN_sparse.py:147``)."""
    total = masked_segment_sum(data, segment_ids, num_segments, mask)
    ones = torch.ones(data.shape[0], dtype=data.dtype, device=data.device)
    denom = masked_segment_sum(ones, segment_ids, num_segments, mask)
    denom = torch.where(denom == 0, torch.ones_like(denom), denom)
    return total / denom.reshape((-1,) + (1,) * (data.dim() - 1))


def receiver_sum(data: torch.Tensor, recv_ptr: torch.Tensor
                 ) -> torch.Tensor:
    """f32 [N, ...] sums of the per-edge rows ``data`` [E, ...] (f32 or
    bf16; the first ``recv_ptr[-1]`` rows are the real edges in receiver
    order, any rows after them padding) over the CSR segments
    ``recv_ptr`` [N+1]: K3 forward and K4 backward on the card (the pool
    pair, ``add_pool``), their plain versions on the CPU."""
    flat = data.reshape(data.shape[0], -1)
    out = add_pool(flat, recv_ptr)
    return out.reshape((out.shape[0],) + tuple(data.shape[1:]))


def receiver_mean(data: torch.Tensor, recv_ptr: torch.Tensor
                  ) -> torch.Tensor:
    """``receiver_sum`` over the in-degree ``recv_ptr.diff()``, clamped
    to 1 (the reference's empty-segment guard, ``GSN_sparse.py:147``)."""
    total = receiver_sum(data, recv_ptr)
    denom = torch.clamp(recv_ptr.diff().to(torch.float32), min=1.0)
    return total / denom.reshape((-1,) + (1,) * (data.dim() - 1))


class _SegmentGather(torch.autograd.Function):
    """``rows[idx]``; backward the sums of the cotangent's rows over the
    CSR segments ``ptr`` (through ``perm``), in ``rows``' dtype."""

    @staticmethod
    def forward(ctx, rows, idx, ptr, perm):
        if ptr.numel() - 1 != rows.shape[0]:
            raise ValueError(f"edge gather: {ptr.numel() - 1} segments, "
                             f"{rows.shape[0]} rows")
        ctx.save_for_backward(ptr, perm)
        ctx.rows_dtype = rows.dtype
        return rows[idx]

    @staticmethod
    def backward(ctx, g):
        ptr, perm = ctx.saved_tensors
        return (segment_sum_sorted(g.contiguous(), ptr, perm, ctx.rows_dtype),
                None, None, None)


def receiver_gather(rows: torch.Tensor, recv: torch.Tensor,
                    seg: EdgeSegments) -> torch.Tensor:
    """``rows[recv]`` [E, d] over every edge slot (the node rows
    ``rows`` [N, d] at each edge's receiver); its backward sums the
    cotangent's real rows over ``seg.recv_ptr`` (K3 on the card, its
    plain version on the CPU).  Padding slots lie outside every segment,
    so their cotangent is never read: the callers rely on it being 0,
    as it is where the messages reach the output only through the
    receiver sums over ``recv_ptr`` and batch statistics are taken under
    the edge mask."""
    return _SegmentGather.apply(rows, recv, seg.recv_ptr, None)


def sender_gather(rows: torch.Tensor, send: torch.Tensor,
                  seg: EdgeSegments) -> torch.Tensor:
    """``rows[send]`` [E, d] over every edge slot (the sender rows, in
    the all-gathered sender space under edge partitioning); its backward
    sums the cotangent's real rows over ``seg.send_ptr`` through
    ``seg.send_perm``, as the kernel path's dB.  Padding slots: as
    ``receiver_gather``."""
    return _SegmentGather.apply(rows, send, seg.send_ptr, seg.send_perm)


class _TableLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.num_rows = table.shape[0]
        return torch.nn.functional.embedding(idx, table)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        one_hot = g.new_zeros(idx.numel(), ctx.num_rows)
        one_hot.scatter_(1, idx[:, None], 1.0)
        return one_hot.t() @ g, None


def table_lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` (an embedding lookup; ``idx`` int64) whose backward
    is the product ``one_hot(idx)ᵀ · g``: each table row's gradient rows
    summed in a fixed order, where ``nn.Embedding``'s backward adds them
    with float atomics on the card.  The tables are small vocabularies
    (at most a few hundred rows), so the one-hot matrix is too."""
    return _TableLookup.apply(table, idx)


def masked_segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int,
                       mask: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Max; empty segments get 0 (DGL's max_nodes yields 0 on empty).
    Plain PyTorch (``scatter_reduce`` amax): it serves the softmax
    aggregator's logit max, the max readout and the plain aggregators;
    the DGN layer's max/min run their kernel
    (``ops/cuda/slab_minmax.py``)."""
    if mask is not None:
        data = torch.where(mask.reshape((-1,) + (1,) * (data.dim() - 1)),
                           data, torch.full_like(data, float("-inf")))
    out = torch.full((num_segments,) + tuple(data.shape[1:]),
                     float("-inf"), dtype=data.dtype, device=data.device)
    idx = segment_ids.long().reshape((-1,) + (1,) * (data.dim() - 1))
    out = out.scatter_reduce(0, idx.expand_as(data), data, "amax")
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


def broadcast_graph_to_nodes(vn: torch.Tensor, graph_ptr: torch.Tensor,
                             num_nodes: int) -> torch.Tensor:
    """``vn[batch]`` (the GNN_OGB virtual-node broadcast, reference
    ``models_graph_classification_ogb_original.py:236``) through B4 over
    the batch's ``graph_ptr``, in ``vn``'s dtype (f32 or bf16); its
    gradient is the add-pool.  Padding nodes get 0, as on the
    reference's kernel path (they are masked everywhere downstream)."""
    return graph_broadcast(vn, graph_ptr, num_nodes)


def global_add_pool(x: torch.Tensor, graph_ptr: torch.Tensor,
                    axis: Optional[str] = None) -> torch.Tensor:
    """Per-graph sum readout (reference global_add_pool_sparse) through
    the pool kernel over the batch's ``graph_ptr`` [num_graphs+1]
    (padding nodes lie outside every graph's range, so no mask is
    needed): f32 rows, or bf16 rows summed in f32; f32 out.  ``axis``:
    the partial sums of the ranks' node blocks are summed over it."""
    out = add_pool(x, graph_ptr)
    return out if axis is None else all_reduce(out, axis)


def global_mean_pool(x: torch.Tensor, graph_ptr: torch.Tensor,
                     axis: Optional[str] = None) -> torch.Tensor:
    """Per-graph mean readout with empty-graph zero-guard (reference
    global_mean_pool_sparse, ``utils_graph_learning.py:32-41``); f32 out
    from f32 or bf16 rows, as ``global_add_pool``.  ``axis``: sums and
    node counts are summed over the ranks before the division."""
    counts = graph_ptr.diff().to(torch.float32)
    if axis is not None:
        counts = all_reduce(counts, axis)
    denom = torch.where(counts == 0, torch.ones_like(counts), counts)
    return global_add_pool(x, graph_ptr, axis) / denom[:, None]
