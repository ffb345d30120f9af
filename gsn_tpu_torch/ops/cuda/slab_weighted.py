"""Per-edge weighted aggregation (B5) and the fused DGN aggregation (B8),
on kernels K5/K6 (``csrc/dgn_aggregate.cu``), with K3 for the sender
side of the backward.

Counterpart of ``gsn_tpu/ops/pallas/slab_weighted.py``:

- ``weighted_gather`` (``slab_weighted_gather``): for every receiver v
  and weight column k, ``out[v, k·d:(k+1)·d] = Σ_{e→v} W[e,k]·B[send e]``
  — the DGN mean, sum and directional aggregators in one pass.  Its
  gradient: ``dh_e = Σ_k W[e,k]·g_k[v]``, ``dW[e,k] = ⟨B[send e],
  g_k[v]⟩`` and ``dB`` the sender sums of dh (K3).
- ``dgn_fused`` (``slab_dgn_fused``): the weighted sums and the
  ``[max, −min]`` of ``slab_minmax.segment_minmax`` from one walk that
  gathers each sender row once; one backward launch merges both dh terms.

The TPU kernel computed the weighted sums as bf16 one-hot products split
three ways (about 2^-16 relative); the kernel here sums in exact f32.
W has one row per edge slot, in the batch's receiver-sorted order; the
kernels read only the real edges' rows (``recv_ptr``'s ranges), and dh
and dW are zero past them.

B is f32 or bf16 (``ops/cuda/dgn_aggregate.py``); W, the outputs and dW
are f32.  In bf16 the rounding points are the reference's
(``slab_weighted.py:89-94, 117-128, 300-303, 327-344``): each W[e, k]
is rounded to bf16 inside the forward's product, g_w is rounded to bf16,
dW is the f32 sum of the bf16 values, and dh (f32 W, and the minmax part
in f32) is rounded once before K3 sums it into bf16 dB.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import build
from .dgn_aggregate import launch_bwd, launch_fwd
from .slab_combine import segment_sum_sorted
from .slab_message import EdgeSegments, receivers
from .slab_minmax import minmax_dh_f32, segment_minmax_fwd_plain


def pad_edges(x: torch.Tensor, slots: int) -> torch.Tensor:
    """``x`` [E_real, ...] with zero rows appended up to ``slots``."""
    out = x.new_zeros((slots,) + tuple(x.shape[1:]))
    out[:x.shape[0]] = x
    return out


def weighted_gather_fwd_plain(B, W, recv_ptr, send) -> torch.Tensor:
    """Plain PyTorch version of the weighted forward: [N, K·d] f32 (W
    rounded to B's dtype)."""
    recv = receivers(recv_ptr)
    e = recv.numel()
    h = B[send[:e]].float()
    w = W[:e].to(B.dtype).float()
    n, K, d = recv_ptr.numel() - 1, W.shape[1], B.shape[1]
    out = torch.zeros(n, K, d, dtype=torch.float32, device=B.device)
    out.index_add_(0, recv, w[:, :, None] * h[:, None, :])
    return out.reshape(n, K * d)


def _weighted_dh_dw(B, W, g_w, recv_ptr, send, need_dw):
    """(f32 dh [E, d] before its rounding, dW [E, K] or None) from g_w
    rounded to B's dtype; zero rows past the real edges."""
    recv = receivers(recv_ptr)
    e, slots = recv.numel(), send.numel()
    K, d = W.shape[1], B.shape[1]
    g_e = g_w.to(B.dtype).float().reshape(-1, K, d)[recv]
    dh = pad_edges((W[:e, :, None] * g_e).sum(1), slots)
    dW = (pad_edges((B[send[:e]].float()[:, None, :] * g_e).sum(2), slots)
          if need_dw else None)
    return dh, dW


def weighted_gather_bwd_plain(B, W, g_w, recv_ptr, send, need_dw=False
                              ) -> Tuple[torch.Tensor,
                                         Optional[torch.Tensor]]:
    """Plain PyTorch version of the weighted backward: (dh [E, d] in B's
    dtype, dW [E, K] f32 or None)."""
    dh, dW = _weighted_dh_dw(B, W, g_w, recv_ptr, send, need_dw)
    return dh.to(B.dtype), dW


@build.counted
def weighted_gather_fwd(B: torch.Tensor, W: torch.Tensor,
                        recv_ptr: torch.Tensor, send: torch.Tensor
                        ) -> torch.Tensor:
    """[N, K·d] f32 weighted sums (see module docstring).  CPU tensors
    take the plain version; CUDA tensors launch K5."""
    if not build.on_cuda(B):
        return weighted_gather_fwd_plain(B, W, recv_ptr, send)
    out, _, _ = launch_fwd("weighted_gather_fwd", B, W, recv_ptr, send,
                           minmax=False)
    build.count(weighted_gather_fwd, build.dtype_name(B.dtype))
    return out


@build.counted
def weighted_gather_bwd(B, W, g_w, recv_ptr, send, need_dw=False):
    """(dh [E, d] in B's dtype, dW [E, K] f32 or None); g_w is rounded
    to B's dtype.  CPU tensors take the plain version; CUDA tensors
    launch K6."""
    if not build.on_cuda(B):
        return weighted_gather_bwd_plain(B, W, g_w, recv_ptr, send, need_dw)
    out = launch_bwd("weighted_gather_bwd", B, W,
                     g_w.to(B.dtype).contiguous(), None, None, None,
                     recv_ptr, send, need_dw)
    build.count(weighted_gather_bwd, build.dtype_name(B.dtype))
    return out


def dgn_fused_fwd_plain(B, W, recv_ptr, send):
    """Plain PyTorch version of the fused forward: (out, mm, cnt)."""
    mm, cnt = segment_minmax_fwd_plain(B, recv_ptr, send)
    return weighted_gather_fwd_plain(B, W, recv_ptr, send), mm, cnt


def dgn_fused_bwd_plain(B, W, g_w, mm, cnt, g_mm, recv_ptr, send,
                        need_dw=False):
    """Plain PyTorch version of the fused backward: (dh in B's dtype, the
    f32 sum of both parts rounded once; dW or None)."""
    dh, dW = _weighted_dh_dw(B, W, g_w, recv_ptr, send, need_dw)
    dh = dh + minmax_dh_f32(B, mm, cnt, g_mm, recv_ptr, send)
    return dh.to(B.dtype), dW


@build.counted
def dgn_fused_fwd(B, W, recv_ptr, send):
    """(out [N, K·d], mm [N, 2d], cnt [N, 2d]) from one walk, all f32.
    CPU tensors take the plain version; CUDA tensors launch K5."""
    if not build.on_cuda(B):
        return dgn_fused_fwd_plain(B, W, recv_ptr, send)
    out = launch_fwd("dgn_fused_fwd", B, W, recv_ptr, send, minmax=True)
    build.count(dgn_fused_fwd, build.dtype_name(B.dtype))
    return out


@build.counted
def dgn_fused_bwd(B, W, g_w, mm, cnt, g_mm, recv_ptr, send, need_dw=False):
    """(dh [E, d] in B's dtype, dW [E, K] f32 or None) of both outputs;
    g_w is rounded to B's dtype.  CPU tensors take the plain version;
    CUDA tensors launch K6."""
    if not build.on_cuda(B):
        return dgn_fused_bwd_plain(B, W, g_w, mm, cnt, g_mm, recv_ptr, send,
                                   need_dw)
    out = launch_bwd("dgn_fused_bwd", B, W, g_w.to(B.dtype).contiguous(),
                     mm, cnt, g_mm, recv_ptr, send, need_dw)
    build.count(dgn_fused_bwd, build.dtype_name(B.dtype))
    return out


def _dB(ctx, dh, seg):
    if not ctx.needs_input_grad[0]:
        return None
    return segment_sum_sorted(dh, seg.send_ptr, seg.send_perm, dh.dtype)


class WeightedGather(torch.autograd.Function):
    """Autograd wrapper: K5 forward; K6 (dh, dW) and K3 (dB) backward.
    dB comes back in B's dtype, dW in f32."""

    @staticmethod
    def forward(ctx, B, W, seg: EdgeSegments):
        B, W = B.contiguous(), W.contiguous()
        ctx.save_for_backward(B, W)
        ctx.seg = seg
        return weighted_gather_fwd(B, W, seg.recv_ptr, seg.send)

    @staticmethod
    def backward(ctx, g):
        B, W = ctx.saved_tensors
        seg = ctx.seg
        dh, dW = weighted_gather_bwd(B, W, g.contiguous(), seg.recv_ptr,
                                     seg.send, ctx.needs_input_grad[1])
        return _dB(ctx, dh, seg), dW, None


class DGNFused(torch.autograd.Function):
    """Autograd wrapper: one K5 forward for both outputs; one K6
    backward (dh, dW) and K3 (dB)."""

    @staticmethod
    def forward(ctx, B, W, seg: EdgeSegments):
        B, W = B.contiguous(), W.contiguous()
        out, mm, cnt = dgn_fused_fwd(B, W, seg.recv_ptr, seg.send)
        ctx.save_for_backward(B, W, mm, cnt)
        ctx.seg = seg
        return out, mm

    @staticmethod
    def backward(ctx, g_w, g_mm):
        B, W, mm, cnt = ctx.saved_tensors
        seg = ctx.seg
        n = seg.recv_ptr.numel() - 1
        if g_w is None:
            g_w = torch.zeros(n, W.shape[1] * B.shape[1], dtype=B.dtype,
                              device=B.device)
        if g_mm is None:
            g_mm = torch.zeros_like(mm)
        dh, dW = dgn_fused_bwd(B, W, g_w.contiguous(), mm, cnt,
                               g_mm.contiguous(), seg.recv_ptr, seg.send,
                               ctx.needs_input_grad[1])
        return _dB(ctx, dh, seg), dW, None


def weighted_gather(B: torch.Tensor, W: torch.Tensor,
                    seg: EdgeSegments) -> torch.Tensor:
    """Differentiable weighted sums [N, K·d] (see module docstring)."""
    return WeightedGather.apply(B, W, seg)


def dgn_fused(B: torch.Tensor, W: torch.Tensor, seg: EdgeSegments
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable (weighted sums [N, K·d], ``[max, −min]`` [N, 2d])."""
    return DGNFused.apply(B, W, seg)
