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

The data (A, B, Pe, g and every output but db1) is f32 or bf16, one
dtype for all of it; b1 and db1 are f32.  In bf16 (the reference's
``data_dtype="bfloat16"``) H is computed in f32 from the bf16 values,
in the order above (so the relu mask is the reference's), each message
is rounded to bf16, row sums accumulate in f32 and are rounded once, g
is rounded to bf16, and dH, a masked copy of g, is exact.

``act="id_sq"`` is the fused-BN moments pass of the message MLP: the
output is ``Σ_{e→v} [H, H²]`` [N, 2d], in f32 for either data dtype
(H from the data as given, in the same order); the backward takes an
f32 [N, 2d] cotangent, unrounded, and ``dH = g₁ + 2H·g₂`` is f32; dA
is rounded once to A's dtype, dB is K3 from the f32 dH into B's dtype,
dPe is dH in Pe's dtype and db1 its f32 sum.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import build
from .slab_combine import DATA_DTYPES, segment_sum_sorted

# the message MLP activations the fused path takes
ACTS = ("relu", "identity")
# the kernels' activation codes: ACTS and the fused-BN moments pass
ACT_CODES = {"identity": 0, "relu": 1, "id_sq": 2}


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
    # in f32, in the reference kernel's order: B[send] + A[recv] + Pe + b1
    h = B[send].float()
    if A is not None:
        h = h + A[recv].float()
    if Pe is not None:
        h = h + Pe[:send.numel()].float()
    return h + b1


def _sender_range(send: torch.Tensor):
    """(smallest, largest) sender id of ``send``, or None when it is
    empty.  Read back once per tensor and kept on it, so a batch's
    segments pay one device read however many kernels they feed (the
    port never writes into a ``send`` tensor)."""
    cached = getattr(send, "_gsn_sender_range", None)
    if cached is None:
        cached = (tuple(int(v) for v in torch.aminmax(send))
                  if send.numel() else ())
        send._gsn_sender_range = cached
    return cached or None


def check_senders(what: str, B: torch.Tensor, send: torch.Tensor,
                  send_ptr: Optional[torch.Tensor] = None) -> None:
    """Raise unless every id of ``send`` is a row of B and, when given,
    ``send_ptr`` holds B.shape[0] + 1 offsets."""
    n_send = B.shape[0]
    if send_ptr is not None and send_ptr.numel() - 1 != n_send:
        raise ValueError(f"{what}: send_ptr has {send_ptr.numel() - 1} "
                         f"segments, B has {n_send} rows")
    rng = _sender_range(send)
    if rng is not None and (rng[0] < 0 or rng[1] >= n_send):
        raise ValueError(f"{what}: sender ids span [{rng[0]}, {rng[1]}], "
                         f"B has {n_send} rows")


def _check_act(act: str) -> None:
    if act not in ACT_CODES:
        raise ValueError(f"edge message activation {act!r}: the kernels "
                         f"take {tuple(ACT_CODES)}")


def _moment_dtype(act, dtype):
    """The dtype of K1's output, K2's cotangent and dH: f32 for id_sq,
    else the data dtype."""
    return torch.float32 if act == "id_sq" else dtype


def edge_message_fwd_plain(A, B, Pe, b1, recv_ptr, send, act="relu"):
    """Plain PyTorch version of K1: relu/identity in B's dtype (messages
    rounded to it, summed in f32, the sum rounded once); id_sq the f32
    [N, 2d] sums of [H, H²]."""
    _check_act(act)
    check_senders("edge_message_fwd", B, send)
    recv = receivers(recv_ptr)
    h = _pre_activation(A, B, Pe, b1, recv, send)
    if act == "relu":
        h = torch.relu(h)
    if act == "id_sq":
        h = torch.cat([h, h * h], dim=1)
    else:
        h = h.to(B.dtype).float()
    out = torch.zeros(recv_ptr.numel() - 1, h.shape[1],
                      dtype=torch.float32, device=B.device)
    return out.index_add_(0, recv, h).to(_moment_dtype(act, B.dtype))


def edge_message_bwd_recv_plain(A, B, Pe, b1, g, recv_ptr, send,
                                act="relu", num_edge_slots=None):
    """Plain PyTorch version of K2: (dH [slots, d], dA [N, d] or None).
    relu/identity in B's dtype (g rounded to it; dA summed in f32,
    rounded once); id_sq from the f32 [N, 2d] g, dH f32 and dA rounded
    once to B's dtype."""
    _check_act(act)
    check_senders("edge_message_bwd_recv", B, send)
    recv = receivers(recv_ptr)
    d = B.shape[1]
    dh = g.to(_moment_dtype(act, B.dtype))[recv]
    if act != "identity":
        h = _pre_activation(A, B, Pe, b1, recv, send)
        if act == "relu":
            dh = torch.where(h > 0, dh, torch.zeros_like(dh))
        else:
            dh = dh[:, :d] + 2.0 * h * dh[:, d:]
    slots = send.numel() if num_edge_slots is None else num_edge_slots
    dH = torch.zeros(slots, d, dtype=dh.dtype, device=g.device)
    dH[:send.numel()] = dh
    dA = None
    if A is not None:
        dA = torch.zeros(A.shape, dtype=torch.float32,
                         device=g.device).index_add_(
                             0, recv, dh.float()).to(B.dtype)
    return dH, dA


def _check_cuda(what, A, B, Pe, b1, g, recv_ptr, send, act):
    _check_act(act)
    dev = B.device
    sq = act == "id_sq"
    build.require(what, dev, A, B, Pe, None if sq else g, dtype=DATA_DTYPES)
    build.require(what, dev, b1, g if sq else None, dtype=torch.float32)
    build.require(what, dev, recv_ptr, send, dtype=torch.int32)
    d = B.shape[1]
    n_rows = recv_ptr.numel() - 1
    for name, t, rows, width in (("A", A, n_rows, d),
                                 ("g", g, n_rows, 2 * d if sq else d),
                                 ("Pe", Pe, None, d)):
        if t is not None and (t.dim() != 2 or t.shape[1] != width
                              or (rows is not None and t.shape[0] != rows)):
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}")
    if b1.shape != (d,):
        raise ValueError(f"{what}: b1 has shape {tuple(b1.shape)}")
    if Pe is not None and Pe.shape[0] < send.numel():
        raise ValueError(f"{what}: Pe has fewer rows than edges")
    check_senders(what, B, send)


def _suffix(dtype) -> str:
    """The C entry point's suffix for the data dtype."""
    return "_bf16" if dtype == torch.bfloat16 else ""


def _mode(act, dtype) -> str:
    """A launch's mode: the data dtype, and ``id_sq`` for that pass."""
    return build.dtype_name(dtype) + (" id_sq" if act == "id_sq" else "")


@build.counted
def edge_message_fwd(A: Optional[torch.Tensor], B: torch.Tensor,
                     Pe: Optional[torch.Tensor], b1: torch.Tensor,
                     recv_ptr: torch.Tensor, send: torch.Tensor,
                     act: str = "relu") -> torch.Tensor:
    """K1: [N, d] ``agg`` in the data dtype, f32 or bf16, or with
    ``act="id_sq"`` the f32 [N, 2d] moments (see module docstring); A
    (``has_a``) and Pe (``has_pe``) may be None.  CPU tensors take the
    plain version."""
    if not build.on_cuda(B):
        return edge_message_fwd_plain(A, B, Pe, b1, recv_ptr, send, act)
    _check_cuda("edge_message_fwd", A, B, Pe, b1, None, recv_ptr, send,
                act)
    n_rows, d = recv_ptr.numel() - 1, B.shape[1]
    width = 2 * d if act == "id_sq" else d
    out = torch.empty(n_rows, width, dtype=_moment_dtype(act, B.dtype),
                      device=B.device)
    if n_rows == 0 or d == 0:
        return out
    fn = getattr(build.lib("edge_message"),
                 "gsn_edge_message_fwd" + _suffix(B.dtype))
    rc = fn(build.ptr(A), build.ptr(B), build.ptr(Pe), build.ptr(b1),
            build.ptr(recv_ptr), build.ptr(send), build.ptr(out), n_rows, d,
            ACT_CODES[act], int(A is not None), int(Pe is not None),
            build.stream_ptr(B.device))
    build.check(rc, "edge_message_fwd")
    build.count(edge_message_fwd, _mode(act, B.dtype), width=d)
    return out


@build.counted
def edge_message_bwd_recv(A, B, Pe, b1, g, recv_ptr, send, act="relu",
                          num_edge_slots=None):
    """K2: (dH [num_edge_slots, d], dA [N, d] or None when A is None).
    dH is in the data dtype and g must have it on the card, or with
    ``act="id_sq"`` g is the f32 [N, 2d] cotangent of the moments and dH
    is f32; dA is in the data dtype.  ``num_edge_slots`` defaults to the
    real edge count; slots past the real edges get zero rows."""
    if not build.on_cuda(g):
        return edge_message_bwd_recv_plain(A, B, Pe, b1, g, recv_ptr,
                                           send, act, num_edge_slots)
    _check_cuda("edge_message_bwd_recv", A, B, Pe, b1, g, recv_ptr, send,
                act)
    n_rows, d = recv_ptr.numel() - 1, B.shape[1]
    e_real = send.numel()
    slots = e_real if num_edge_slots is None else num_edge_slots
    dH = torch.empty(slots, d, dtype=g.dtype, device=g.device)
    dH[e_real:].zero_()
    dA = (torch.empty(n_rows, d, dtype=B.dtype, device=g.device)
          if A is not None else None)
    if n_rows == 0 or d == 0:
        return dH, dA
    fn = getattr(build.lib("edge_message"),
                 "gsn_edge_message_bwd_recv" + _suffix(B.dtype))
    rc = fn(build.ptr(A), build.ptr(B), build.ptr(Pe), build.ptr(b1),
            build.ptr(g), build.ptr(recv_ptr), build.ptr(send), build.ptr(dH),
            build.ptr(dA), n_rows, d, ACT_CODES[act], int(A is not None),
            int(Pe is not None), build.stream_ptr(g.device))
    build.check(rc, "edge_message_bwd_recv")
    build.count(edge_message_bwd_recv, _mode(act, B.dtype), width=d)
    return dH, dA


class EdgeMessageAggregate(torch.autograd.Function):
    """Autograd wrapper: K1 forward; K2 (dH, dA) and K3 (dB) backward.
    Each gradient comes back in its input's dtype: dA, dB and dPe in the
    data dtype, db1 in f32 (an f32 sum of dH).  The cotangent is rounded
    to the output's dtype (the data dtype, or f32 for id_sq)."""

    @staticmethod
    def forward(ctx, A, B, Pe, b1, seg: EdgeSegments, act: str):
        A = A.contiguous() if A is not None else None
        B = B.contiguous()
        Pe = Pe.contiguous() if Pe is not None else None
        check_senders("edge_message_aggregate", B, seg.send, seg.send_ptr)
        ctx.save_for_backward(A, B, Pe, b1)
        ctx.seg, ctx.act = seg, act
        return edge_message_fwd(A, B, Pe, b1, seg.recv_ptr, seg.send, act)

    @staticmethod
    def backward(ctx, g):
        A, B, Pe, b1 = ctx.saved_tensors
        seg = ctx.seg
        slots = Pe.shape[0] if Pe is not None else seg.send.numel()
        g = g.to(_moment_dtype(ctx.act, B.dtype)).contiguous()
        dH, dA = edge_message_bwd_recv(A, B, Pe, b1, g, seg.recv_ptr,
                                       seg.send, ctx.act, slots)
        dB = (segment_sum_sorted(dH, seg.send_ptr, seg.send_perm, B.dtype)
              if ctx.needs_input_grad[1] else None)
        dPe = (dH.to(Pe.dtype) if Pe is not None and ctx.needs_input_grad[2]
               else None)
        # a constant b1 (the ogb message's zeros) skips the [E, d] reduction
        db1 = dH.float().sum(0) if ctx.needs_input_grad[3] else None
        return dA, dB, dPe, db1, None, None


def edge_message_aggregate(A, B, Pe, b1, seg: EdgeSegments,
                           act: str = "relu") -> torch.Tensor:
    """Differentiable ``agg`` [N, d] in the data dtype, or the f32
    [N, 2d] moments for ``act="id_sq"`` (see module docstring)."""
    return EdgeMessageAggregate.apply(A, B, Pe, b1, seg, act)
