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
W has one row per real edge, in the batch's receiver-sorted order.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import build
from .dgn_aggregate import launch_bwd, launch_fwd
from .slab_combine import segment_sum_sorted
from .slab_message import EdgeSegments, receivers
from .slab_minmax import minmax_dh_plain, segment_minmax_fwd_plain


def weighted_gather_fwd_plain(B, W, recv_ptr, send) -> torch.Tensor:
    """Plain PyTorch version of the weighted forward: [N, K·d]."""
    recv = receivers(recv_ptr)
    h = B[send].float()
    n, K, d = recv_ptr.numel() - 1, W.shape[1], B.shape[1]
    out = torch.zeros(n, K, d, dtype=torch.float32, device=B.device)
    out.index_add_(0, recv, W[:, :, None] * h[:, None, :])
    return out.reshape(n, K * d)


def weighted_gather_bwd_plain(B, W, g_w, recv_ptr, send, need_dw=False
                              ) -> Tuple[torch.Tensor,
                                         Optional[torch.Tensor]]:
    """Plain PyTorch version of the weighted backward: (dh [E, d],
    dW [E, K] or None)."""
    recv = receivers(recv_ptr)
    K, d = W.shape[1], B.shape[1]
    g_e = g_w.reshape(-1, K, d)[recv]
    dh = (W[:, :, None] * g_e).sum(1)
    dW = (B[send].float()[:, None, :] * g_e).sum(2) if need_dw else None
    return dh, dW


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
    build.count(weighted_gather_fwd, "f32")
    return out



@build.counted
def weighted_gather_bwd(B, W, g_w, recv_ptr, send, need_dw=False):
    """(dh [E, d], dW [E, K] or None).  CPU tensors take the plain
    version; CUDA tensors launch K6."""
    if not build.on_cuda(B):
        return weighted_gather_bwd_plain(B, W, g_w, recv_ptr, send, need_dw)
    out = launch_bwd("weighted_gather_bwd", B, W, g_w, None, None, None,
                     recv_ptr, send, need_dw)
    build.count(weighted_gather_bwd, "f32")
    return out



def dgn_fused_fwd_plain(B, W, recv_ptr, send):
    """Plain PyTorch version of the fused forward: (out, mm, cnt)."""
    mm, cnt = segment_minmax_fwd_plain(B, recv_ptr, send)
    return weighted_gather_fwd_plain(B, W, recv_ptr, send), mm, cnt


def dgn_fused_bwd_plain(B, W, g_w, mm, cnt, g_mm, recv_ptr, send,
                        need_dw=False):
    """Plain PyTorch version of the fused backward: (dh, dW or None)."""
    dh, dW = weighted_gather_bwd_plain(B, W, g_w, recv_ptr, send, need_dw)
    return dh + minmax_dh_plain(B, mm, cnt, g_mm, recv_ptr, send), dW


@build.counted
def dgn_fused_fwd(B, W, recv_ptr, send):
    """(out [N, K·d], mm [N, 2d], cnt [N, 2d]) from one walk.  CPU
    tensors take the plain version; CUDA tensors launch K5."""
    if not build.on_cuda(B):
        return dgn_fused_fwd_plain(B, W, recv_ptr, send)
    out = launch_fwd("dgn_fused_fwd", B, W, recv_ptr, send, minmax=True)
    build.count(dgn_fused_fwd, "f32")
    return out



@build.counted
def dgn_fused_bwd(B, W, g_w, mm, cnt, g_mm, recv_ptr, send, need_dw=False):
    """(dh [E, d], dW [E, K] or None) of both outputs.  CPU tensors take
    the plain version; CUDA tensors launch K6."""
    if not build.on_cuda(B):
        return dgn_fused_bwd_plain(B, W, g_w, mm, cnt, g_mm, recv_ptr, send,
                                   need_dw)
    out = launch_bwd("dgn_fused_bwd", B, W, g_w, mm, cnt, g_mm, recv_ptr,
                     send, need_dw)
    build.count(dgn_fused_bwd, "f32")
    return out



def _dB(ctx, dh, seg):
    if not ctx.needs_input_grad[0]:
        return None
    return segment_sum_sorted(dh, seg.send_ptr, seg.send_perm)


class WeightedGather(torch.autograd.Function):
    """Autograd wrapper: K5 forward; K6 (dh, dW) and K3 (dB) backward."""

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
            g_w = torch.zeros(n, W.shape[1] * B.shape[1], device=B.device)
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
