"""Fused edge-message aggregation: kernels K1 and K2
(``csrc/edge_message.cu``), with K3 for the sender side of the backward.

Counterpart of ``gsn_tpu/ops/pallas/slab_message.py``'s
``slab_edge_message_aggregate``::

    agg[v] = Σ_{e: recv(e)=v} act(B[send e] + A[v] + Pe[e] + b1)

with ``act`` relu or identity.  Its gradient: ``dH = act'(H)·g[recv]``,
``dA`` the receiver sums of dH (K2), ``dB`` the sender sums of dH (K3
over the host-built sender-sorted permutation, deterministic),
``dPe = dH`` and ``db1 = Σ_e dH`` (each only where its input needs a
gradient).  Edges are the batch's real edges in
receiver-sorted order (``GraphBatch.recv_ptr``); Pe and dH keep the
batch's edge-slot rows, padding slots last (dH is zero there).

Only f32 runs on the card here: bf16 inputs and the ``id_sq`` moments
mode (fused BN inside the message MLP) raise on a CUDA tensor.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import build
from .slab_combine import segment_sum_sorted

ACTS = ("relu", "identity")


class EdgeSegments(NamedTuple):
    """Receiver- and sender-side CSR views of a batch's real edges."""
    recv_ptr: torch.Tensor    # [N+1] int32
    send: torch.Tensor        # [E_real] int32, receiver-sorted order
    send_ptr: torch.Tensor    # [N_send+1] int32
    send_perm: torch.Tensor   # [E_real] int32 positions, sender-sorted


def receivers(recv_ptr: torch.Tensor) -> torch.Tensor:
    """[E] int64 receiver of each edge from the CSR offsets ``recv_ptr``."""
    n = recv_ptr.numel() - 1
    return torch.repeat_interleave(
        torch.arange(n, device=recv_ptr.device), recv_ptr.diff())


def _pre_activation(A, B, Pe, b1, recv, send):
    # the reference kernel's order: B[send] + A[recv] + Pe + b1
    h = B[send]
    if A is not None:
        h = h + A[recv]
    if Pe is not None:
        h = h + Pe[:send.numel()]
    return h + b1


def _check_act(act: str) -> None:
    if act not in ACTS:
        raise ValueError(f"edge message activation {act!r}: the kernels "
                         f"take {ACTS}")


def edge_message_fwd_plain(A, B, Pe, b1, recv_ptr, send, act="relu"):
    """Plain PyTorch version of K1."""
    _check_act(act)
    recv = receivers(recv_ptr)
    h = _pre_activation(A, B, Pe, b1, recv, send)
    if act == "relu":
        h = torch.relu(h)
    out = torch.zeros(recv_ptr.numel() - 1, B.shape[1],
                      dtype=torch.float32, device=B.device)
    return out.index_add_(0, recv, h)


def edge_message_bwd_recv_plain(A, B, Pe, b1, g, recv_ptr, send,
                                act="relu", num_edge_slots=None):
    """Plain PyTorch version of K2: (dH [slots, d], dA [N, d] or None)."""
    _check_act(act)
    recv = receivers(recv_ptr)
    dh = g[recv]
    if act == "relu":
        h = _pre_activation(A, B, Pe, b1, recv, send)
        dh = torch.where(h > 0, dh, torch.zeros_like(dh))
    slots = send.numel() if num_edge_slots is None else num_edge_slots
    dH = torch.zeros(slots, g.shape[1], dtype=torch.float32,
                     device=g.device)
    dH[:send.numel()] = dh
    dA = None
    if A is not None:
        dA = torch.zeros_like(g).index_add_(0, recv, dh)
    return dH, dA


def _check_cuda(what, A, B, Pe, b1, g, recv_ptr, send, act):
    _check_act(act)
    dev = B.device
    build.require(what, dev, A, B, Pe, b1, g, dtype=torch.float32)
    build.require(what, dev, recv_ptr, send, dtype=torch.int32)
    d = B.shape[1]
    n_rows = recv_ptr.numel() - 1
    for name, t, rows in (("A", A, n_rows), ("g", g, n_rows),
                          ("Pe", Pe, None)):
        if t is not None and (t.dim() != 2 or t.shape[1] != d
                              or (rows is not None and t.shape[0] != rows)):
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}")
    if b1.shape != (d,):
        raise ValueError(f"{what}: b1 has shape {tuple(b1.shape)}")
    if Pe is not None and Pe.shape[0] < send.numel():
        raise ValueError(f"{what}: Pe has fewer rows than edges")


def edge_message_fwd(A: Optional[torch.Tensor], B: torch.Tensor,
                     Pe: Optional[torch.Tensor], b1: torch.Tensor,
                     recv_ptr: torch.Tensor, send: torch.Tensor,
                     act: str = "relu") -> torch.Tensor:
    """K1: [N, d] f32 ``agg`` (see module docstring); A (``has_a``) and
    Pe (``has_pe``) may be None.  CPU tensors take the plain version."""
    if not build.on_cuda(B):
        return edge_message_fwd_plain(A, B, Pe, b1, recv_ptr, send, act)
    _check_cuda("edge_message_fwd", A, B, Pe, b1, None, recv_ptr, send,
                act)
    n_rows, d = recv_ptr.numel() - 1, B.shape[1]
    out = torch.empty(n_rows, d, dtype=torch.float32, device=B.device)
    if n_rows == 0 or d == 0:
        return out
    rc = build.lib("edge_message").gsn_edge_message_fwd(
        build.ptr(A), build.ptr(B), build.ptr(Pe), build.ptr(b1),
        build.ptr(recv_ptr), build.ptr(send), build.ptr(out), n_rows, d,
        int(act == "relu"), int(A is not None), int(Pe is not None),
        build.stream_ptr(B.device))
    build.check(rc, "edge_message_fwd")
    edge_message_fwd.launches += 1
    return out


edge_message_fwd.launches = 0


def edge_message_bwd_recv(A, B, Pe, b1, g, recv_ptr, send, act="relu",
                          num_edge_slots=None):
    """K2: (dH [num_edge_slots, d], dA [N, d] or None when A is None).
    ``num_edge_slots`` defaults to the real edge count; slots past the
    real edges get zero rows."""
    if not build.on_cuda(g):
        return edge_message_bwd_recv_plain(A, B, Pe, b1, g, recv_ptr,
                                           send, act, num_edge_slots)
    _check_cuda("edge_message_bwd_recv", A, B, Pe, b1, g, recv_ptr, send,
                act)
    n_rows, d = recv_ptr.numel() - 1, g.shape[1]
    e_real = send.numel()
    slots = e_real if num_edge_slots is None else num_edge_slots
    dH = torch.empty(slots, d, dtype=torch.float32, device=g.device)
    dH[e_real:].zero_()
    dA = torch.empty_like(g) if A is not None else None
    if n_rows == 0 or d == 0:
        return dH, dA
    rc = build.lib("edge_message").gsn_edge_message_bwd_recv(
        build.ptr(A), build.ptr(B), build.ptr(Pe), build.ptr(b1),
        build.ptr(g), build.ptr(recv_ptr), build.ptr(send), build.ptr(dH),
        build.ptr(dA), n_rows, d, int(act == "relu"), int(A is not None),
        int(Pe is not None), build.stream_ptr(g.device))
    build.check(rc, "edge_message_bwd_recv")
    edge_message_bwd_recv.launches += 1
    return dH, dA


edge_message_bwd_recv.launches = 0


class EdgeMessageAggregate(torch.autograd.Function):
    """Autograd wrapper: K1 forward; K2 (dH, dA) and K3 (dB) backward."""

    @staticmethod
    def forward(ctx, A, B, Pe, b1, seg: EdgeSegments, act: str):
        A = A.contiguous() if A is not None else None
        B = B.contiguous()
        Pe = Pe.contiguous() if Pe is not None else None
        ctx.save_for_backward(A, B, Pe, b1)
        ctx.seg, ctx.act = seg, act
        return edge_message_fwd(A, B, Pe, b1, seg.recv_ptr, seg.send, act)

    @staticmethod
    def backward(ctx, g):
        A, B, Pe, b1 = ctx.saved_tensors
        seg = ctx.seg
        slots = Pe.shape[0] if Pe is not None else seg.send.numel()
        dH, dA = edge_message_bwd_recv(A, B, Pe, b1, g.contiguous(),
                                       seg.recv_ptr, seg.send, ctx.act,
                                       slots)
        dB = (segment_sum_sorted(dH, seg.send_ptr, seg.send_perm)
              if ctx.needs_input_grad[1] else None)
        dPe = dH if Pe is not None and ctx.needs_input_grad[2] else None
        # a constant b1 (the ogb message's zeros) skips the [E, d] reduction
        db1 = dH.sum(0) if ctx.needs_input_grad[3] else None
        return dA, dB, dPe, db1, None, None


def edge_message_aggregate(A, B, Pe, b1, seg: EdgeSegments,
                           act: str = "relu") -> torch.Tensor:
    """Differentiable ``agg`` [N, d] (see module docstring)."""
    return EdgeMessageAggregate.apply(A, B, Pe, b1, seg, act)
