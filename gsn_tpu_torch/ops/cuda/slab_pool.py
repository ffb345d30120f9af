"""Graph add-pool: K3 forward, kernel K4 (``csrc/segment_broadcast.cu``)
backward.

Counterpart of ``gsn_tpu/ops/pallas/slab_pool.py``'s ``slab_add_pool``:
per-graph sums of node rows by the sorted ``batch`` vector, and its
backward ``dx = g[batch]`` with 0 on padding rows.  The batch's
``graph_ptr`` [G+1] gives each graph's node range (padding nodes lie
outside every range).
"""

from __future__ import annotations

import torch

from . import build
from .slab_combine import segment_sum_sorted


def segment_broadcast_plain(g: torch.Tensor, ptr: torch.Tensor,
                            n_rows: int) -> torch.Tensor:
    """Plain PyTorch version of K4."""
    n_seg = ptr.numel() - 1
    seg = torch.repeat_interleave(
        torch.arange(n_seg, device=g.device), ptr.diff())
    out = torch.zeros(n_rows, g.shape[1], dtype=torch.float32,
                      device=g.device)
    out[int(ptr[0]):int(ptr[-1])] = g[seg].float()
    return out


def segment_broadcast(g: torch.Tensor, ptr: torch.Tensor,
                      n_rows: int) -> torch.Tensor:
    """[n_rows, d]: row v is ``g[k]`` for the segment k holding v
    (``ptr[k] <= v < ptr[k+1]``), 0 outside every segment.  CPU tensors
    take the plain version; CUDA tensors launch K4 (f32 only)."""
    if not build.on_cuda(g):
        return segment_broadcast_plain(g, ptr, n_rows)
    build.require("segment_broadcast", g.device, g, dtype=torch.float32)
    build.require("segment_broadcast", g.device, ptr, dtype=torch.int32)
    if g.dim() != 2:
        raise ValueError("segment_broadcast: g must be [K, d]")
    d = g.shape[1]
    out = torch.empty(n_rows, d, dtype=torch.float32, device=g.device)
    if n_rows == 0 or d == 0:
        return out
    rc = build.lib("segment_broadcast").gsn_segment_broadcast(
        build.ptr(g), build.ptr(ptr), ptr.numel() - 1, build.ptr(out),
        n_rows, d, build.stream_ptr(g.device))
    build.check(rc, "segment_broadcast")
    segment_broadcast.launches += 1
    return out


segment_broadcast.launches = 0


class AddPool(torch.autograd.Function):
    """pool[k] = Σ_{v∈[graph_ptr[k], graph_ptr[k+1])} x[v]; backward
    ``dx = g[graph(v)]``, 0 on padding rows."""

    @staticmethod
    def forward(ctx, x, graph_ptr):
        ctx.save_for_backward(graph_ptr)
        ctx.n_rows = x.shape[0]
        return segment_sum_sorted(x.contiguous(), graph_ptr)

    @staticmethod
    def backward(ctx, g):
        (graph_ptr,) = ctx.saved_tensors
        return segment_broadcast(g.contiguous(), graph_ptr, ctx.n_rows), None


def add_pool(x: torch.Tensor, graph_ptr: torch.Tensor) -> torch.Tensor:
    """[G, d] f32 per-graph sums of the node rows ``x`` [N, d]."""
    return AddPool.apply(x, graph_ptr)
