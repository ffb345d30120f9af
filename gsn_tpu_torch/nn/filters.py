"""GSN / MPNN message-passing layer (counterpart of
``gsn_tpu/nn/filters.py``).

Message kinds:

- ``general`` (reference ``GSN_sparse.py:157-176``): per-edge
  ``m = MLP(cat(x_i, x_j, ids, e))``, update ``MLP(cat(x, Σ_j m))``;
- ``gin`` (reference ``GSN_sparse.py:103-111``, ``gsn_tpu/nn/
  filters.py:396-483``): ``m = cat(x_j, id, e)``, update
  ``MLP((1+ε)·cat(x, id_ii, e_ii) + Σ_j m)``, where local-scope ids and
  edge features get a dummy self-loop feature from ``CentralEncoder``.
  The sum of concatenations is the concatenation of per-part sums: one
  K1/K2 call a part in identity mode with no A side and a zero ``b1``,
  ``B = x`` (and the ids at global scope) for a node part, and a zero
  B with ``Pe`` the edge-level rows (local ids, edge features) for an
  edge part;
- ``ogb`` (reference ``GSN_edge_sparse_ogb.py:119-129``):
  ``m = relu(x_j + id + e)``, self message ``x + id`` (global scope)
  else ``x``, update ``MLP((1+ε)·self + Σ_j m)``.  The message is K1/K2's
  ``act(A[recv] + B[send] + Pe + b1)`` with no A side, ``B = x`` (plus
  the ids at global scope), ``Pe`` the sum of the edge-level ids and
  edge features, and a constant zero ``b1``.

``compute_dtype=torch.bfloat16`` mirrors the reference's bf16 mode
(``gsn_tpu/nn/filters.py:95-145, 203-221, 526-574``): every dense layer
of the message and update MLPs computes in bf16, the kernel path's data
is bf16 (f32 bias), the aggregate and the layer's output stay bf16, and
BN statistics are f32.

``general`` messages with ``bn_mlp`` take the kernels only in bf16, as
in the reference (``gsn_tpu/nn/filters.py:162-193, 355-371``): the
message MLP's BN is folded into the first layer.  In training one
``id_sq`` pass gives the masked moments of the pre-activation H, the BN
turns them into (mean, var) and its running statistics, and
``s = weight·rsqrt(var + eps)`` scales A, B and Pe (an f32 product
rounded once to bf16) while the bias becomes ``(b1 − mean)·s + bias``;
the relu pass then runs on those.  In eval the running statistics fold
in.  In f32, ``bn_mlp`` messages stay on the per-edge path.

Per-edge messages are summed (``aggr="add"``) or averaged
(``aggr="mean"``) at their receivers through the batch's receiver-sorted
segment layout (``receiver_sum`` / ``receiver_mean`` over ``recv_ptr``:
K3 forward, K4 backward), each receiver's messages in one fixed order:
the reference sums them with a segment sum (``gsn_tpu/nn/filters.py:581-
586``), and a float-atomic ``index_add`` here made two runs of one seed
part within an epoch on the card.  The per-edge gathers of node rows
(``A[recv]``, ``B[send]``, the ``ogb`` and ``gin`` kinds' sender rows)
take the same segments for their backward (``receiver_gather`` /
``sender_gather``: K3 over ``recv_ptr``, and over ``send_ptr`` through
``send_perm``), so the padding slots, all at node slot 0, are never
walked; without a segment layout they are plain indexing.  Each gather
built counts ``edge_gather.segment`` or ``edge_gather.index``
(``spans.count``).

Under edge partitioning (``ep_axis``, the batch a shard of
``parallel/ep.py::make_ep_batch``) the node rows are the shard's block,
the receivers local and the senders global: the sender side crosses the
ranks once per layer through an all-gather (``gsn_tpu/nn/filters.py:
139-160, 228-229, 305-319, 436-453, 512-534``) — for the ``general``
kind's kernel path only the projected B rows, so K1/K2 run with B in
the gathered sender space (the ``num_send_nodes`` mode) while A stays
local; for per-edge messages B and the sender rows of x.  ``bn_mlp``
messages then take the fused-BN kernel path in f32 too, as in the
reference, where the per-edge path would gather d_in-wide rows.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from gsn_tpu_torch.ops.cuda.slab_message import (ACTS, EdgeSegments,
                                                 edge_message_aggregate)
from gsn_tpu_torch.ops.norm import MaskedBatchNorm
from gsn_tpu_torch.ops.segment import (masked_segment_mean,
                                       masked_segment_sum, receiver_gather,
                                       receiver_mean, receiver_sum,
                                       sender_gather)
from gsn_tpu_torch.parallel.collectives import all_gather
from gsn_tpu_torch.spans import count
from .embedding import CentralEncoder
from .mlp import MLP, choose_activation, dense


def _cat_promoted(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """``cat(parts, -1)`` in their promoted dtype, as ``jnp.concatenate``
    promotes."""
    dtype = functools.reduce(torch.promote_types, [p.dtype for p in parts])
    return torch.cat([p.to(dtype) for p in parts], -1)


def edge_gather(rows: torch.Tensor, idx: torch.Tensor,
                seg: Optional[EdgeSegments], side: str) -> torch.Tensor:
    """``rows[idx]`` over every edge slot, ``idx`` the receivers
    (``side="recv"``) or the senders (``"send"``): with the batch's
    segments ``seg`` its backward is K3 over them (``receiver_gather`` /
    ``sender_gather``), else plain indexing."""
    if seg is None:
        count("edge_gather.index")
        return rows[idx]
    count("edge_gather.segment")
    gather = receiver_gather if side == "recv" else sender_gather
    return gather(rows, idx, seg)


class EdgeMessageMLP(nn.Module):
    """Message MLP whose *first* dense layer is evaluated at node level.

    ``MLP(cat(x_i, x_j, id_i, id_j, [e]))``'s first layer is a linear map
    of a concatenation, i.e. a sum of per-part matmuls.  Node-level parts
    are projected once per node (``dense_0_p*``) and gathered per edge;
    edge-level parts are projected on edges.

    ``node_parts``: ``(width, mode)`` per node-level input, mode ``recv``,
    ``send`` or ``both`` (projected twice, gathered at both endpoints).
    ``edge_parts``: width per edge-level input.  ``dtype``: the compute
    dtype of the dense layers (each input is cast to it).  ``axis_name``:
    the mesh axis its BN statistics are summed over.
    """

    def __init__(self, node_parts: Sequence[Tuple[int, str]],
                 edge_parts: Sequence[int], d_out: int,
                 d_hidden: Sequence[int], activation: str = "elu",
                 batch_norm: bool = False,
                 dtype: Optional[torch.dtype] = None,
                 axis_name: Optional[str] = None):
        super().__init__()
        self.dtype = dtype
        self.widths = list(d_hidden) + [d_out]
        self.activation = activation
        self.act = choose_activation(activation)
        self.batch_norm = batch_norm
        d1 = self.widths[0]
        # (projection index, gather side) per node-level input, in order
        self.node_proj: List[List[Tuple[int, str]]] = []
        li = 0
        for width, mode in node_parts:
            sides = ["recv", "send"] if mode == "both" else [mode]
            self.node_proj.append([])
            for side in sides:
                setattr(self, f"dense_0_p{li}",
                        nn.Linear(width, d1, bias=False))
                self.node_proj[-1].append((li, side))
                li += 1
        self.edge_proj = []
        for width in edge_parts:
            setattr(self, f"dense_0_p{li}", nn.Linear(width, d1, bias=False))
            self.edge_proj.append(li)
            li += 1
        self.dense_0_bias = nn.Parameter(torch.zeros(d1))
        if len(self.widths) > 1 and batch_norm:
            self.bn_0 = MaskedBatchNorm(d1, axis_name=axis_name)
        for i in range(1, len(self.widths)):
            d_prev, d = self.widths[i - 1], self.widths[i]
            if i == len(self.widths) - 1:
                setattr(self, f"dense_{i}", nn.Linear(d_prev, d, bias=False))
                setattr(self, f"dense_{i}_bias",
                        nn.Parameter(torch.zeros(d)))
            else:
                setattr(self, f"dense_{i}", nn.Linear(d_prev, d))
                if batch_norm:
                    setattr(self, f"bn_{i}",
                            MaskedBatchNorm(d, axis_name=axis_name))

    @property
    def fusable(self) -> bool:
        """The fused kernel path takes at most one hidden layer and a
        relu/identity activation; batch norm inside the MLP only in bf16
        (the reference's routing: its f32 fused-BN pass lost to the
        per-edge path)."""
        return self.fusable_under(ep=False)

    def fusable_under(self, ep: bool) -> bool:
        """``fusable``, and under edge partitioning also batch norm in
        f32 (reference ``filters.py:355-363``)."""
        return (len(self.widths) <= 2 and self.activation in ACTS
                and (not self.batch_norm or self.dtype == torch.bfloat16
                     or ep))

    def _fold_bn(self, A, B, pe, bias, seg, in_degree):
        """BN of the pre-activation H = A[recv] + B[send] + Pe + bias
        folded into its affine inputs (reference filters.py:162-193): the
        masked moments of H over the real edges come from one id_sq pass
        in training, the running statistics in eval."""
        bn = self.bn_0
        moments = None
        if bn.training:
            hs = edge_message_aggregate(A, B, pe, bias, seg, "id_sq")
            d = hs.shape[1] // 2
            moments = (in_degree.sum(), hs[:, :d].sum(0), hs[:, d:].sum(0))
        mean, var, weight, beta = bn(None, moments=moments)
        s = weight * torch.rsqrt(var + bn.eps)

        def scale(x):   # an f32 product, rounded once to the data dtype
            return None if x is None else (x.float() * s).to(self.dtype)

        return scale(A), scale(B), scale(pe), (bias - mean) * s + beta

    def forward(self, node_parts, edge_parts, recv, send, edge_mask=None,
                seg: Optional[EdgeSegments] = None,
                in_degree: Optional[torch.Tensor] = None,
                ep_axis: Optional[str] = None,
                fused: bool = False) -> torch.Tensor:
        """``fused`` (``seg`` given): the fused kernel path, returning the
        aggregated [N, d_out]; otherwise per-edge messages [E, d_out],
        gathered through ``seg`` when given (``edge_gather``).
        ``ep_axis``: the send-side rows B are all-gathered over it
        (global sender ids)."""
        dt = self.dtype
        A = B = pe = None   # node-level recv-/send-side sums, edge sum
        for arr, projs in zip(node_parts, self.node_proj):
            for li, side in projs:
                p = dense(getattr(self, f"dense_0_p{li}"), arr, dt)
                if side == "recv":
                    A = p if A is None else A + p
                else:
                    B = p if B is None else B + p
        for arr, li in zip(edge_parts, self.edge_proj):
            p = dense(getattr(self, f"dense_0_p{li}"), arr, dt)
            pe = p if pe is None else pe + p
        bias = self.dense_0_bias
        if ep_axis is not None and B is not None:
            B = all_gather(B, ep_axis)

        if fused:
            if not self.fusable_under(ep_axis is not None):
                raise ValueError("this message MLP has no fused path")
            # a single-dense MLP has no hidden activation (reference
            # models_misc.mlp applies act between layers only)
            act_k = self.activation if len(self.widths) > 1 else "identity"
            if self.batch_norm and len(self.widths) > 1:
                A, B, pe, bias = self._fold_bn(A, B, pe, bias, seg,
                                               in_degree)
            agg = edge_message_aggregate(A, B, pe, bias, seg, act_k)
            if len(self.widths) == 1:
                return agg
            # the second dense commutes with the sum; its per-message
            # bias contributes in_degree * bias at each node (computed in
            # f32, rounded once to the compute dtype)
            out = dense(self.dense_1, agg, dt)
            return out + (in_degree[:, None]
                          * self.dense_1_bias).to(out.dtype)

        h = None
        if A is not None:
            h = edge_gather(A, recv, seg, "recv")
        if B is not None:
            b = edge_gather(B, send, seg, "send")
            h = b if h is None else h + b
        if pe is not None:
            h = pe if h is None else h + pe
        h = h + bias.to(h.dtype)
        if len(self.widths) == 1:
            return h
        if self.batch_norm:
            h = self.bn_0(h, edge_mask)
        h = self.act(h)
        last = len(self.widths) - 1
        for i in range(1, last + 1):
            h = dense(getattr(self, f"dense_{i}"), h, dt)
            if i == last:
                h = h + getattr(self, f"dense_{i}_bias").to(h.dtype)
            else:
                if self.batch_norm:
                    h = getattr(self, f"bn_{i}")(h, edge_mask)
                h = self.act(h)
        return h


class GSNLayer(nn.Module):
    """One GSN/MPNN layer of the ``general``, ``gin`` or ``ogb`` kind.

    ``d_in``: node feature width; ``d_id`` / ``d_ef`` / ``d_degree``: the
    encoded identifier, edge feature and degree widths (used when the
    layer consumes them); ``train_eps``: the gin and ogb kinds' learned ε
    (parameter ``eps``, initially 0), else ε = 0;
    ``id_embedding_kind`` / ``edge_embedding_kind`` / ``extend_dims``:
    the gin kind's ``CentralEncoder`` of the ids (``central_id``) and
    edge features (``central_ef``); ``compute_dtype``: None (f32) or
    ``torch.bfloat16``."""

    def __init__(self, d_in: int, d_up: int, d_msg: Optional[int] = None,
                 d_h: Sequence[int] = (), msg_kind: str = "general",
                 id_scope: str = "global", use_ids: bool = False,
                 use_edge_features: bool = False, d_id: int = 0,
                 d_ef: int = 0, degree_as_tag: bool = False,
                 d_degree: int = 0, retain_features: bool = True,
                 aggr: str = "add", flow: str = "target_to_source",
                 activation_mlp: str = "elu", bn_mlp: bool = False,
                 train_eps: bool = False,
                 id_embedding_kind: str = "one_hot_encoder",
                 edge_embedding_kind: str = "one_hot_encoder",
                 extend_dims: bool = True,
                 compute_dtype: Optional[torch.dtype] = None,
                 bn_axis_name: Optional[str] = None):
        super().__init__()
        if msg_kind not in ("general", "gin", "ogb"):
            raise NotImplementedError(f"msg kind {msg_kind!r}")
        if aggr not in ("add", "mean"):
            raise NotImplementedError(f"aggregation {aggr!r}")
        self.msg_kind = msg_kind
        self.id_scope, self.use_ids = id_scope, use_ids
        self.use_edge_features = use_edge_features
        self.degree_as_tag, self.retain_features = (degree_as_tag,
                                                    retain_features)
        self.aggr, self.flow = aggr, flow
        self.compute_dtype = compute_dtype
        if degree_as_tag:
            d_in = d_in + d_degree if retain_features else d_degree
        if msg_kind in ("gin", "ogb"):
            if msg_kind == "ogb":
                # x + ids broadcasts to the wider of the two (global scope)
                d_self = (max(d_in, d_id)
                          if use_ids and id_scope == "global" else d_in)
            else:
                # the self message cat(x, id_ii, e_ii)
                d_self = d_in
                if use_ids:
                    if id_scope == "local":
                        self.central_id = CentralEncoder(
                            id_embedding_kind, d_id, extend_dims)
                        d_self += self.central_id.d_out
                    else:
                        d_self += d_id
                if use_edge_features:
                    self.central_ef = CentralEncoder(
                        edge_embedding_kind, d_ef, extend_dims)
                    d_self += self.central_ef.d_out
            if train_eps:
                self.eps = nn.Parameter(torch.zeros(()))
            self.update_fn = MLP(d_self, d_up, tuple(d_h), activation_mlp,
                                 bn_mlp, compute_dtype, bn_axis_name)
            return
        node_parts = [(d_in, "both")]
        edge_parts = []
        if use_ids:
            if id_scope == "local":
                edge_parts.append(d_id)
            else:
                node_parts.append((d_id, "both"))
        if use_edge_features:
            edge_parts.append(d_ef)
        d_msg_out = d_msg if d_msg is not None else d_in
        self.msg_fn = EdgeMessageMLP(node_parts, edge_parts, d_msg_out,
                                     tuple(d_h), activation_mlp, bn_mlp,
                                     compute_dtype, bn_axis_name)
        self.update_fn = MLP(d_in + d_msg_out, d_up, tuple(d_h),
                             activation_mlp, bn_mlp, compute_dtype,
                             bn_axis_name)

    def forward(self, x, edge_index, identifiers=None, degrees=None,
                edge_features=None, node_mask=None, edge_mask=None,
                seg: Optional[EdgeSegments] = None, in_degree=None,
                ep_axis: Optional[str] = None):
        """``seg``/``in_degree``: the batch's segment layout; the fused
        kernel path runs when it is given and the layer is eligible
        (add aggregation and a fusable message MLP), else the per-edge
        gathers' backward runs over it.  ``ep_axis``: the
        batch is an edge-partitioned shard (``edge_index`` row 0 the
        local receivers, row 1 the global senders)."""
        if self.degree_as_tag:
            deg = degrees if degrees.dim() > 1 else degrees[:, None]
            deg = deg.to(x.dtype)
            x = torch.cat([x, deg], -1) if self.retain_features else deg
        n_nodes = x.shape[0]
        # the partitioner's convention: row 0 the receiver, flow applied
        select = (0 if ep_axis is not None or self.flow == "target_to_source"
                  else 1)
        recv, send = edge_index[select], edge_index[1 - select]
        if self.msg_kind == "ogb":
            return self._ogb(x, recv, send, identifiers, edge_features,
                             node_mask, edge_mask, seg, ep_axis)
        if self.msg_kind == "gin":
            return self._gin(x, recv, send, identifiers, edge_features,
                             node_mask, edge_mask, seg, ep_axis)

        node_parts = [x]
        edge_parts = []
        if self.use_ids:
            ids = identifiers.to(torch.float32)
            if self.id_scope == "local":
                edge_parts.append(ids)
            else:
                node_parts.append(ids)
        if self.use_edge_features:
            edge_parts.append(edge_features)
        msg_fn = self.msg_fn
        fused = (seg is not None and self.aggr == "add"
                 and msg_fn.fusable_under(ep_axis is not None))
        out = msg_fn(node_parts, edge_parts, recv, send, edge_mask, seg,
                     in_degree, ep_axis, fused)
        # the fused path's aggregate stays in the compute dtype; per-edge
        # messages are summed in f32 (reference filters.py:385-394)
        agg = out if fused else self._aggregate(out.float(), recv, n_nodes,
                                                edge_mask, seg)
        return self.update_fn(torch.cat([x.to(agg.dtype), agg], -1),
                              node_mask)

    def _aggregate(self, msgs, recv, n_nodes, edge_mask, seg=None):
        """Sum (or mean) of the per-edge messages at their receivers;
        with ``seg``, a sorted segment sum over its ``recv_ptr`` (the
        padding edges at the tail lie outside every segment), else a
        masked ``index_add``."""
        if seg is not None:
            return (receiver_sum(msgs, seg.recv_ptr) if self.aggr == "add"
                    else receiver_mean(msgs, seg.recv_ptr))
        if self.aggr == "add":
            return masked_segment_sum(msgs, recv, n_nodes, edge_mask)
        return masked_segment_mean(msgs, recv, n_nodes, edge_mask)

    def _ogb(self, x, recv, send, identifiers, edge_features, node_mask,
             edge_mask, seg, ep_axis=None):
        """The ``ogb`` kind (reference ``gsn_tpu/nn/filters.py:485-559``).
        With ``seg`` and add aggregation the message runs K1/K2 (the
        reference's slab path: ``pe = ids + e`` first, then the sender
        row added inside the kernel); otherwise per edge,
        ``relu((x_j + ids) + e)`` and a masked segment sum.  In a compute
        dtype the kernel's data is cast to it (f32 ids are promoted
        first, as in the reference, filters.py:514-559)."""
        ids = (identifiers.to(torch.float32) if self.use_ids else None)
        ef = edge_features if self.use_edge_features else None
        # self message and the kernel's sender side: x, plus the
        # node-level ids at global scope
        self_msg = x
        if ids is not None and self.id_scope == "global":
            self_msg = x + identifiers.to(x.dtype)
        if seg is not None and self.aggr == "add":
            pe = None
            for p in (ids if self.id_scope == "local" else None, ef):
                if p is not None:
                    pe = p if pe is None else pe + p
            dm = self_msg.shape[-1]
            if pe is not None and pe.shape[-1] != dm:
                if pe.shape[-1] != 1:
                    raise ValueError(
                        f"ogb message: edge-level width {pe.shape[-1]} "
                        f"does not broadcast to the node width {dm}")
                pe = pe.expand(-1, dm)
            kdt = self.compute_dtype or torch.float32
            b1 = torch.zeros(dm, dtype=torch.float32, device=x.device)
            B = self_msg.to(kdt)
            if ep_axis is not None:
                B = all_gather(B, ep_axis)
            agg = edge_message_aggregate(
                None, B, pe.to(kdt) if pe is not None else None, b1, seg,
                "relu")
        else:
            def full(a):   # the sender rows of every shard under ep
                return a if ep_axis is None else all_gather(a, ep_axis)

            m = edge_gather(full(x), send, seg, "send")
            if ids is not None:
                m = m + (ids if self.id_scope == "local"
                         else edge_gather(full(ids), send, seg, "send"))
            if ef is not None:
                m = m + ef
            agg = self._aggregate(torch.relu(m), recv, x.shape[0],
                                  edge_mask, seg)
        # (1+ε) and the self message in the aggregate's dtype
        update_in = self_msg.to(agg.dtype)
        if hasattr(self, "eps"):
            update_in = (1.0 + self.eps).to(agg.dtype) * update_in
        return self.update_fn(update_in + agg, node_mask)

    def _gin(self, x, recv, send, identifiers, edge_features, node_mask,
             edge_mask, seg, ep_axis=None):
        """The ``gin`` kind (reference ``gsn_tpu/nn/filters.py:396-483``).
        The parts in order: x, the ids (node-level at global scope,
        edge-level with their central row at local scope), the edge
        features (edge-level, with their central row).  With ``seg``
        and add aggregation each part is one K1/K2 call in the compute
        dtype; otherwise the per-edge ``cat(x_j, ids, e)`` is summed at
        the receivers."""
        n_nodes = x.shape[0]
        self_parts = [x]
        parts = [(x, "node")]
        if self.use_ids:
            ids = identifiers.to(torch.float32)
            if self.id_scope == "local":
                id_ii, ids = self.central_id(ids, n_nodes)
                self_parts.append(id_ii)
                parts.append((ids, "edge"))
            else:
                self_parts.append(ids)
                parts.append((ids, "node"))
        if self.use_edge_features:
            ef_ii, ef = self.central_ef(edge_features, n_nodes)
            self_parts.append(ef_ii)
            parts.append((ef, "edge"))
        self_msg = _cat_promoted(self_parts)

        def full(a):   # the sender rows of every shard under ep
            return a if ep_axis is None else all_gather(a, ep_axis)

        if seg is not None and self.aggr == "add":
            kdt = self.compute_dtype or torch.float32
            n_send = seg.send_ptr.numel() - 1
            agg_parts = []
            for arr, level in parts:
                dm = arr.shape[-1]
                b1 = torch.zeros(dm, dtype=torch.float32, device=x.device)
                if level == "node":
                    B, Pe = full(arr.to(kdt)), None
                else:
                    # an edge part: a constant zero sender side
                    B = torch.zeros(n_send, dm, dtype=kdt, device=x.device)
                    Pe = arr.to(kdt)
                agg_parts.append(edge_message_aggregate(
                    None, B, Pe, b1, seg, "identity"))
            agg = torch.cat(agg_parts, -1)
        else:
            msgs = _cat_promoted([edge_gather(full(arr), send, seg, "send")
                                  if level == "node" else arr
                                  for arr, level in parts])
            agg = self._aggregate(msgs, recv, n_nodes, edge_mask,
                                  seg).to(msgs.dtype)
        # (1+ε) and the self message in the aggregate's dtype
        update_in = self_msg.to(agg.dtype)
        if hasattr(self, "eps"):
            update_in = (1.0 + self.eps).to(agg.dtype) * update_in
        return self.update_fn(update_in + agg, node_mask)
