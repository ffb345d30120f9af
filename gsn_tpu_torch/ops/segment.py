"""Masked segment reductions and graph pooling (counterpart of
``gsn_tpu/ops/segment.py``).

``global_add_pool`` / ``global_mean_pool`` and the virtual node's
``broadcast_graph_to_nodes`` route through the pool kernels
(``ops/cuda/slab_pool.py``) over the batch's ``graph_ptr``; the masked
segment sums serve the message layers' unfused aggregation.
"""

from __future__ import annotations

from typing import Optional

import torch

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
    the batch's ``graph_ptr``; its gradient is the add-pool.  Padding
    nodes get 0, as on the reference's kernel path (they are masked
    everywhere downstream)."""
    return graph_broadcast(vn, graph_ptr, num_nodes)


def global_add_pool(x: torch.Tensor, graph_ptr: torch.Tensor
                    ) -> torch.Tensor:
    """Per-graph sum readout (reference global_add_pool_sparse) through
    the pool kernel over the batch's ``graph_ptr`` [num_graphs+1]
    (padding nodes lie outside every graph's range, so no mask is
    needed)."""
    return add_pool(x, graph_ptr)


def global_mean_pool(x: torch.Tensor, graph_ptr: torch.Tensor
                     ) -> torch.Tensor:
    """Per-graph mean readout with empty-graph zero-guard (reference
    global_mean_pool_sparse, ``utils_graph_learning.py:32-41``)."""
    counts = graph_ptr.diff().to(torch.float32)
    denom = torch.where(counts == 0, torch.ones_like(counts), counts)
    return add_pool(x, graph_ptr) / denom[:, None]
