"""Launches of the DGN aggregation kernels K5/K6
(``csrc/dgn_aggregate.cu``), shared by the three ops built on them:
``slab_weighted.weighted_gather`` (B5), ``slab_minmax.segment_minmax``
(B6, with B7's combine folded in) and ``slab_weighted.dgn_fused`` (B8).

Each op picks the kernel's instantiation by two flags: ``weighted``
(the K weighted sums ``Σ_e W[e,k]·B[send e]``) and ``minmax`` (the
per-column ``[max, −min]`` of ``B[send e]`` with its tie counts).  The
edges are the batch's real edges in receiver-sorted order; W has one
row per real edge.

The rows B are f32 or bf16 (the reference's ``data_dtype="bfloat16"``);
the weighted cotangent g_w and the per-edge dh have B's dtype, and W,
out, mm, cnt, g_mm and dW are f32 in both.  In bf16 the forward rounds
each weight to bf16 inside the weighted product and sums in f32, mm
holds the bf16 maxima exactly, and dh is summed in f32 (from f32 W and
g_mm) and rounded once.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import build
from .slab_combine import DATA_DTYPES

# most weight columns one launch takes (csrc/dgn_aggregate.cu: kMaxK)
MAX_K = 16


def _check(what, B, W, recv_ptr, send, weighted):
    dev = B.device
    build.require(what, dev, B, dtype=DATA_DTYPES)
    build.require(what, dev, W, dtype=torch.float32)
    build.require(what, dev, recv_ptr, send, dtype=torch.int32)
    if B.dim() != 2:
        raise ValueError(f"{what}: B must be [N, d]")
    if weighted:
        if W.dim() != 2 or W.shape[0] != send.numel():
            raise ValueError(f"{what}: W has shape {tuple(W.shape)}, "
                             f"expected [{send.numel()}, K]")
        if not 1 <= W.shape[1] <= MAX_K:
            raise ValueError(f"{what}: {W.shape[1]} weight columns, the "
                             f"kernel takes 1..{MAX_K}")


def _suffix(dtype) -> str:
    """The C entry point's suffix for B's dtype."""
    return "_bf16" if dtype == torch.bfloat16 else ""


def launch_fwd(what: str, B: torch.Tensor, W: Optional[torch.Tensor],
               recv_ptr: torch.Tensor, send: torch.Tensor,
               minmax: bool) -> Tuple[Optional[torch.Tensor], ...]:
    """K5 on the card: (out [N, K·d] or None, mm [N, 2d] or None,
    cnt [N, 2d] or None) with N = ``recv_ptr.numel() - 1``."""
    weighted = W is not None
    _check(what, B, W, recv_ptr, send, weighted)
    n, d = recv_ptr.numel() - 1, B.shape[1]
    K = W.shape[1] if weighted else 0
    new = lambda w: torch.empty(n, w, dtype=torch.float32,  # noqa: E731
                                device=B.device)
    out = new(K * d) if weighted else None
    mm, cnt = (new(2 * d), new(2 * d)) if minmax else (None, None)
    if n == 0 or d == 0:
        return out, mm, cnt
    rc = getattr(build.lib("dgn_aggregate"),
                 "gsn_dgn_aggregate_fwd" + _suffix(B.dtype))(
        build.ptr(B), build.ptr(W), build.ptr(recv_ptr), build.ptr(send),
        build.ptr(out), build.ptr(mm), build.ptr(cnt), n, d, K,
        int(weighted), int(minmax), build.stream_ptr(B.device))
    build.check(rc, what)
    return out, mm, cnt


def launch_bwd(what: str, B: torch.Tensor, W: Optional[torch.Tensor],
               g_w: Optional[torch.Tensor], mm: Optional[torch.Tensor],
               cnt: Optional[torch.Tensor], g_mm: Optional[torch.Tensor],
               recv_ptr: torch.Tensor, send: torch.Tensor,
               need_dw: bool = False
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K6 on the card: (dh [E, d] in B's dtype, dW [E, K] f32 or None)
    for the E real edges; the weighted part runs when W is given (g_w in
    B's dtype), the minmax part when ``mm`` is."""
    weighted, minmax = W is not None, mm is not None
    _check(what, B, W, recv_ptr, send, weighted)
    build.require(what, B.device, B, g_w, dtype=DATA_DTYPES)
    build.require(what, B.device, mm, cnt, g_mm, dtype=torch.float32)
    n, d = recv_ptr.numel() - 1, B.shape[1]
    K = W.shape[1] if weighted else 0
    for name, t, width in (("g_w", g_w, K * d), ("mm", mm, 2 * d),
                           ("cnt", cnt, 2 * d), ("g_mm", g_mm, 2 * d)):
        if t is not None and tuple(t.shape) != (n, width):
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"expected {(n, width)}")
    if weighted and g_w is None or minmax and (cnt is None or g_mm is None):
        raise ValueError(f"{what}: missing cotangent or tie counts")
    e = send.numel()
    dh = torch.empty(e, d, dtype=B.dtype, device=B.device)
    dW = (torch.empty(e, K, dtype=torch.float32, device=B.device)
          if need_dw else None)
    if n == 0 or d == 0 or e == 0:
        return dh.zero_(), dW.zero_() if need_dw else None
    rc = getattr(build.lib("dgn_aggregate"),
                 "gsn_dgn_aggregate_bwd" + _suffix(B.dtype))(
        build.ptr(B), build.ptr(W), build.ptr(g_w), build.ptr(mm),
        build.ptr(cnt), build.ptr(g_mm), build.ptr(recv_ptr),
        build.ptr(send), build.ptr(dh), build.ptr(dW), n, d, K,
        int(weighted), int(minmax), int(need_dw),
        build.stream_ptr(B.device))
    build.check(rc, what)
    return dh, dW
