"""Segment max and min with tie counts: B6, on kernels K5/K6
(``csrc/dgn_aggregate.cu``, minmax instantiation), with K3 for the
sender side of the backward.

Counterpart of ``gsn_tpu/ops/pallas/slab_minmax.py``'s
``slab_segment_minmax`` and of the chunk combine behind it,
``gsn_tpu/ops/pallas/slab_combine.py``'s ``slab_combine_minmax_cnt``
(B7).  For every receiver v, over its edges e::

    mm[v, :d]  = max_e  B[send e]        (0 for a row with no edges)
    mm[v, d:]  = max_e −B[send e]        (= −min)
    cnt[v, .]  = number of edges attaining mm[v, .]

The TPU kernel produced per-chunk maxima and tie counts and B7 merged
them (``cnt = Σ_c cnt_c·[max_c == max]``); here the receiver walk sees
all of a row's edges, so ``cnt`` comes out of the forward directly.
The backward splits each column's cotangent evenly over the tied edges,
``dh_e = [h_e == max]·g/max(cnt, 1)`` (minus the same for the min
half), as ``jax.ops.segment_max``'s cotangent does; ``dB`` is the
sender sum of dh (K3).

B is f32 or bf16.  Maxima and tie counts are exact in either: bf16 rows
are compared as bf16 values (``slab_minmax.py:71-76``), and mm holds
them in f32.  The cotangent g_mm is f32 and is not rounded; dh is
rounded once to B's dtype, and K3 sums it into dB of that dtype.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import build
from .dgn_aggregate import launch_bwd, launch_fwd
from .slab_combine import segment_sum_sorted
from .slab_message import EdgeSegments, receivers


def segment_minmax_fwd_plain(B: torch.Tensor, recv_ptr: torch.Tensor,
                             send: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the minmax forward: (mm, cnt)."""
    recv = receivers(recv_ptr)
    h = B[send[:recv.numel()]].float()
    hc = torch.cat([h, -h], dim=1)
    n = recv_ptr.numel() - 1
    idx = recv[:, None].expand_as(hc)
    # include_self=False: rows with edges take their edges' max alone,
    # rows without keep the 0 fill
    mm = torch.zeros(n, hc.shape[1], dtype=torch.float32,
                     device=B.device).scatter_reduce(
                         0, idx, hc, "amax", include_self=False)
    tie = (hc == mm[recv]).float()
    cnt = torch.zeros_like(mm).index_add_(0, recv, tie)
    return mm, cnt


def minmax_dh_f32(B, mm, cnt, g_mm, recv_ptr, send) -> torch.Tensor:
    """Plain per-edge cotangent [E, d] of the minmax output in f32: the
    even tie split, written out (not the backward of ``scatter_reduce``);
    zero rows past the real edges."""
    recv = receivers(recv_ptr)
    h = B[send[:recv.numel()]].float()
    hc = torch.cat([h, -h], dim=1)
    gp = g_mm / torch.clamp(cnt, min=1.0)
    dhc = torch.where(hc == mm[recv], gp[recv], torch.zeros_like(hc))
    d = h.shape[1]
    dh = h.new_zeros(send.numel(), d)
    dh[:recv.numel()] = dhc[:, :d] - dhc[:, d:]
    return dh


def minmax_dh_plain(B, mm, cnt, g_mm, recv_ptr, send) -> torch.Tensor:
    """Plain PyTorch version of the minmax backward: ``minmax_dh_f32``
    rounded once to B's dtype."""
    return minmax_dh_f32(B, mm, cnt, g_mm, recv_ptr, send).to(B.dtype)


@build.counted
def segment_minmax_fwd(B: torch.Tensor, recv_ptr: torch.Tensor,
                       send: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mm [N, 2d], cnt [N, 2d]) f32 (see module docstring).  CPU
    tensors take the plain version; CUDA tensors launch K5."""
    if not build.on_cuda(B):
        return segment_minmax_fwd_plain(B, recv_ptr, send)
    _, mm, cnt = launch_fwd("segment_minmax_fwd", B, None, recv_ptr, send,
                            minmax=True)
    build.count(segment_minmax_fwd, build.dtype_name(B.dtype))
    return mm, cnt


@build.counted
def segment_minmax_bwd(B, mm, cnt, g_mm, recv_ptr, send) -> torch.Tensor:
    """dh [E, d] in B's dtype: the cotangent of ``B[send e]`` for every
    real edge.  CPU tensors take the plain version; CUDA tensors launch
    K6."""
    if not build.on_cuda(B):
        return minmax_dh_plain(B, mm, cnt, g_mm, recv_ptr, send)
    dh, _ = launch_bwd("segment_minmax_bwd", B, None, None, mm, cnt, g_mm,
                       recv_ptr, send)
    build.count(segment_minmax_bwd, build.dtype_name(B.dtype))
    return dh


class SegmentMinmax(torch.autograd.Function):
    """Autograd wrapper: K5 forward; K6 (dh) and K3 (dB) backward."""

    @staticmethod
    def forward(ctx, B, seg: EdgeSegments):
        B = B.contiguous()
        mm, cnt = segment_minmax_fwd(B, seg.recv_ptr, seg.send)
        ctx.save_for_backward(B, mm, cnt)
        ctx.seg = seg
        return mm

    @staticmethod
    def backward(ctx, g):
        B, mm, cnt = ctx.saved_tensors
        seg = ctx.seg
        dh = segment_minmax_bwd(B, mm, cnt, g.contiguous(), seg.recv_ptr,
                                seg.send)
        return (segment_sum_sorted(dh, seg.send_ptr, seg.send_perm,
                                   dh.dtype), None)


def segment_minmax(B: torch.Tensor, seg: EdgeSegments) -> torch.Tensor:
    """Differentiable ``[max, −min]`` [N, 2d] of ``B[send]`` per
    receiver (0 on rows with no edges)."""
    return SegmentMinmax.apply(B, seg)
