"""Graph add-pool and graph-to-node broadcast: kernels K3
(``csrc/segment_sum.cu``) and K4 (``csrc/segment_broadcast.cu``).

Counterpart of ``gsn_tpu/ops/pallas/slab_pool.py``:

- ``slab_add_pool`` (B3): per-graph sums of node rows by the sorted
  ``batch`` vector (K3), and its backward ``dx = g[batch]`` with 0 on
  padding rows (K4);
- ``slab_graph_broadcast`` (B4): the virtual node's ``out[v] =
  vn[graph(v)]``, 0 on padding rows.  The TPU build ran B3's backward
  kernel body for it and took B3 as its VJP; here the forward is K4 and
  the backward K3, the same pair transposed.

Rows are f32 or bf16, as in the reference's bf16 mode: the pool sums
bf16 rows in f32 and returns f32 pooled rows, its backward rounds the
cotangent to bf16 and copies it; B4 copies a bf16 ``vn`` as bf16 and
pools its cotangent in f32, rounded once to ``vn``'s dtype.

The batch's ``graph_ptr`` [G+1] gives each graph's node range (padding
nodes lie outside every range).
"""

from __future__ import annotations

import torch

from . import build
from .slab_combine import DATA_DTYPES, segment_sum_sorted


def segment_broadcast_plain(g: torch.Tensor, ptr: torch.Tensor,
                            n_rows: int) -> torch.Tensor:
    """Plain PyTorch version of K4."""
    n_seg = ptr.numel() - 1
    seg = torch.repeat_interleave(
        torch.arange(n_seg, device=g.device), ptr.diff())
    out = torch.zeros(n_rows, g.shape[1], dtype=g.dtype, device=g.device)
    out[int(ptr[0]):int(ptr[-1])] = g[seg]
    return out


@build.counted
def segment_broadcast(g: torch.Tensor, ptr: torch.Tensor,
                      n_rows: int) -> torch.Tensor:
    """[n_rows, d] in ``g``'s dtype: row v is ``g[k]`` for the segment k
    holding v (``ptr[k] <= v < ptr[k+1]``), 0 outside every segment.  CPU
    tensors take the plain version; CUDA tensors launch K4 (f32 or bf16;
    ``g`` may be a view at any offset of whole elements)."""
    if not build.on_cuda(g):
        return segment_broadcast_plain(g, ptr, n_rows)
    build.require("segment_broadcast", g.device, g, dtype=DATA_DTYPES)
    build.require("segment_broadcast", g.device, ptr, dtype=torch.int32)
    if g.dim() != 2:
        raise ValueError("segment_broadcast: g must be [K, d]")
    d = g.shape[1]
    out = torch.empty(n_rows, d, dtype=g.dtype, device=g.device)
    if n_rows == 0 or d == 0:
        return out
    lib = build.lib("segment_broadcast")
    fn = (lib.gsn_segment_broadcast_bf16 if g.dtype == torch.bfloat16
          else lib.gsn_segment_broadcast)
    rc = fn(build.ptr(g), build.ptr(ptr), ptr.numel() - 1, build.ptr(out),
            n_rows, d, build.stream_ptr(g.device))
    build.check(rc, "segment_broadcast")
    build.count(segment_broadcast, build.dtype_name(g.dtype))
    return out


class AddPool(torch.autograd.Function):
    """pool[k] = Σ_{v∈[graph_ptr[k], graph_ptr[k+1])} x[v], f32; backward
    ``dx = g[graph(v)]`` in x's dtype, 0 on padding rows."""

    @staticmethod
    def forward(ctx, x, graph_ptr):
        ctx.save_for_backward(graph_ptr)
        ctx.n_rows, ctx.x_dtype = x.shape[0], x.dtype
        return segment_sum_sorted(x.contiguous(), graph_ptr)

    @staticmethod
    def backward(ctx, g):
        (graph_ptr,) = ctx.saved_tensors
        return segment_broadcast(g.to(ctx.x_dtype).contiguous(), graph_ptr,
                                 ctx.n_rows), None


def add_pool(x: torch.Tensor, graph_ptr: torch.Tensor) -> torch.Tensor:
    """[G, d] f32 per-graph sums of the node rows ``x`` [N, d] (f32, or
    bf16 summed in f32)."""
    return AddPool.apply(x, graph_ptr)


def graph_broadcast_plain(vn: torch.Tensor, graph_ptr: torch.Tensor,
                          n_rows: int) -> torch.Tensor:
    """Plain PyTorch version of B4: ``vn[batch]`` with 0 on padding rows
    (differentiable by autograd; its backward sums in ``vn``'s dtype)."""
    ptr = graph_ptr.long()
    rows = torch.arange(n_rows, device=vn.device)
    batch = torch.searchsorted(ptr, rows, right=True) - 1
    real = (rows >= ptr[0]) & (rows < ptr[-1])
    picked = vn[batch.clamp(0, vn.shape[0] - 1)]
    return torch.where(real[:, None], picked, torch.zeros_like(picked))


class GraphBroadcast(torch.autograd.Function):
    """out[v] = vn[graph(v)], 0 on padding rows (K4); backward
    ``dvn[k] = Σ_{v∈[graph_ptr[k], graph_ptr[k+1])} g[v]`` (K3), summed
    in f32 and rounded once to vn's dtype."""

    @staticmethod
    def forward(ctx, vn, graph_ptr, n_rows):
        ctx.save_for_backward(graph_ptr)
        ctx.vn_dtype = vn.dtype
        out = segment_broadcast(vn.contiguous(), graph_ptr, n_rows)
        if build.on_cuda(vn):
            build.count(graph_broadcast, build.dtype_name(vn.dtype))
        return out

    @staticmethod
    def backward(ctx, g):
        (graph_ptr,) = ctx.saved_tensors
        return segment_sum_sorted(g.to(ctx.vn_dtype).contiguous(), graph_ptr,
                                  out_dtype=ctx.vn_dtype), None, None


@build.counted
def graph_broadcast(vn: torch.Tensor, graph_ptr: torch.Tensor,
                    n_rows: int) -> torch.Tensor:
    """B4: [n_rows, d] node rows in ``vn``'s dtype (f32 or bf16), row v
    holding ``vn[graph(v)]`` (``vn`` [G, d]), 0 on padding rows.  CPU
    tensors take the plain versions of K4 and K3; CUDA tensors launch
    them.  Its ``launches`` counts B4's calls on the card, apart from
    K4's own count, which also holds the pool backward's launches."""
    return GraphBroadcast.apply(vn, graph_ptr, n_rows)
