"""GSN / MPNN message-passing layer (counterpart of
``gsn_tpu/nn/filters.py``).

Ported so far:

- ``general`` (reference ``GSN_sparse.py:157-176``): per-edge
  ``m = MLP(cat(x_i, x_j, ids, e))``, update ``MLP(cat(x, Σ_j m))``;
- ``ogb`` (reference ``GSN_edge_sparse_ogb.py:119-129``):
  ``m = relu(x_j + id + e)``, self message ``x + id`` (global scope)
  else ``x``, update ``MLP((1+ε)·self + Σ_j m)``.  The message is K1/K2's
  ``act(A[recv] + B[send] + Pe + b1)`` with no A side, ``B = x`` (plus
  the ids at global scope), ``Pe`` the sum of the edge-level ids and
  edge features, and a constant zero ``b1``.

The ``gin`` kind raises until a later slice ports it.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from gsn_tpu_torch.ops.cuda.slab_message import (ACTS, EdgeSegments,
                                                 edge_message_aggregate)
from gsn_tpu_torch.ops.norm import MaskedBatchNorm
from gsn_tpu_torch.ops.segment import masked_segment_mean, masked_segment_sum
from .mlp import MLP, choose_activation


class EdgeMessageMLP(nn.Module):
    """Message MLP whose *first* dense layer is evaluated at node level.

    ``MLP(cat(x_i, x_j, id_i, id_j, [e]))``'s first layer is a linear map
    of a concatenation, i.e. a sum of per-part matmuls.  Node-level parts
    are projected once per node (``dense_0_p*``) and gathered per edge;
    edge-level parts are projected on edges.

    ``node_parts``: ``(width, mode)`` per node-level input, mode ``recv``,
    ``send`` or ``both`` (projected twice, gathered at both endpoints).
    ``edge_parts``: width per edge-level input.
    """

    def __init__(self, node_parts: Sequence[Tuple[int, str]],
                 edge_parts: Sequence[int], d_out: int,
                 d_hidden: Sequence[int], activation: str = "elu",
                 batch_norm: bool = False):
        super().__init__()
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
            self.bn_0 = MaskedBatchNorm(d1)
        for i in range(1, len(self.widths)):
            d_prev, d = self.widths[i - 1], self.widths[i]
            if i == len(self.widths) - 1:
                setattr(self, f"dense_{i}", nn.Linear(d_prev, d, bias=False))
                setattr(self, f"dense_{i}_bias",
                        nn.Parameter(torch.zeros(d)))
            else:
                setattr(self, f"dense_{i}", nn.Linear(d_prev, d))
                if batch_norm:
                    setattr(self, f"bn_{i}", MaskedBatchNorm(d))

    @property
    def fusable(self) -> bool:
        """The fused kernel path takes at most one hidden layer, a
        relu/identity activation and no batch norm inside the MLP."""
        return (len(self.widths) <= 2 and self.activation in ACTS
                and not self.batch_norm)

    def forward(self, node_parts, edge_parts, recv, send, edge_mask=None,
                seg: Optional[EdgeSegments] = None,
                in_degree: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``seg`` given: the fused kernel path, returning the aggregated
        [N, d_out]; otherwise per-edge messages [E, d_out]."""
        A = B = pe = None   # node-level recv-/send-side sums, edge sum
        for arr, projs in zip(node_parts, self.node_proj):
            for li, side in projs:
                p = getattr(self, f"dense_0_p{li}")(arr)
                if side == "recv":
                    A = p if A is None else A + p
                else:
                    B = p if B is None else B + p
        for arr, li in zip(edge_parts, self.edge_proj):
            p = getattr(self, f"dense_0_p{li}")(arr)
            pe = p if pe is None else pe + p
        bias = self.dense_0_bias

        if seg is not None:
            if not self.fusable:
                raise ValueError("this message MLP has no fused path")
            # a single-dense MLP has no hidden activation (reference
            # models_misc.mlp applies act between layers only)
            act_k = self.activation if len(self.widths) > 1 else "identity"
            agg = edge_message_aggregate(A, B, pe, bias, seg, act_k)
            if len(self.widths) == 1:
                return agg
            # the second dense commutes with the sum; its per-message
            # bias contributes in_degree * bias at each node
            out = self.dense_1(agg)
            return out + in_degree[:, None] * self.dense_1_bias

        h = None
        if A is not None:
            h = A[recv]
        if B is not None:
            h = B[send] if h is None else h + B[send]
        if pe is not None:
            h = pe if h is None else h + pe
        h = h + bias
        if len(self.widths) == 1:
            return h
        if self.batch_norm:
            h = self.bn_0(h, edge_mask)
        h = self.act(h)
        last = len(self.widths) - 1
        for i in range(1, last + 1):
            h = getattr(self, f"dense_{i}")(h)
            if i == last:
                h = h + getattr(self, f"dense_{i}_bias")
            else:
                if self.batch_norm:
                    h = getattr(self, f"bn_{i}")(h, edge_mask)
                h = self.act(h)
        return h


class GSNLayer(nn.Module):
    """One GSN/MPNN layer of the ``general`` or ``ogb`` kind.

    ``d_in``: node feature width; ``d_id`` / ``d_ef`` / ``d_degree``: the
    encoded identifier, edge feature and degree widths (used when the
    layer consumes them); ``train_eps``: the ogb kind's learned ε
    (parameter ``eps``, initially 0), else ε = 0."""

    def __init__(self, d_in: int, d_up: int, d_msg: Optional[int] = None,
                 d_h: Sequence[int] = (), msg_kind: str = "general",
                 id_scope: str = "global", use_ids: bool = False,
                 use_edge_features: bool = False, d_id: int = 0,
                 d_ef: int = 0, degree_as_tag: bool = False,
                 d_degree: int = 0, retain_features: bool = True,
                 aggr: str = "add", flow: str = "target_to_source",
                 activation_mlp: str = "elu", bn_mlp: bool = False,
                 train_eps: bool = False):
        super().__init__()
        if msg_kind not in ("general", "ogb"):
            raise NotImplementedError(
                f"message kind {msg_kind!r} is not ported yet")
        if aggr not in ("add", "mean"):
            raise NotImplementedError(f"aggregation {aggr!r}")
        self.msg_kind = msg_kind
        self.id_scope, self.use_ids = id_scope, use_ids
        self.use_edge_features = use_edge_features
        self.degree_as_tag, self.retain_features = (degree_as_tag,
                                                    retain_features)
        self.aggr, self.flow = aggr, flow
        if degree_as_tag:
            d_in = d_in + d_degree if retain_features else d_degree
        if msg_kind == "ogb":
            # x + ids broadcasts to the wider of the two (global scope)
            d_self = (max(d_in, d_id) if use_ids and id_scope == "global"
                      else d_in)
            if train_eps:
                self.eps = nn.Parameter(torch.zeros(()))
            self.update_fn = MLP(d_self, d_up, tuple(d_h), activation_mlp,
                                 bn_mlp)
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
                                     tuple(d_h), activation_mlp, bn_mlp)
        self.update_fn = MLP(d_in + d_msg_out, d_up, tuple(d_h),
                             activation_mlp, bn_mlp)

    def forward(self, x, edge_index, identifiers=None, degrees=None,
                edge_features=None, node_mask=None, edge_mask=None,
                seg: Optional[EdgeSegments] = None, in_degree=None):
        """``seg``/``in_degree``: the batch's segment layout; the fused
        kernel path runs when it is given and the layer is eligible
        (add aggregation and a fusable message MLP)."""
        if self.degree_as_tag:
            deg = degrees if degrees.dim() > 1 else degrees[:, None]
            deg = deg.to(x.dtype)
            x = torch.cat([x, deg], -1) if self.retain_features else deg
        n_nodes = x.shape[0]
        select = 0 if self.flow == "target_to_source" else 1
        recv, send = edge_index[select], edge_index[1 - select]
        if self.msg_kind == "ogb":
            return self._ogb(x, recv, send, identifiers, edge_features,
                             node_mask, edge_mask, seg)

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
        fused = (seg is not None and self.aggr == "add"
                 and self.msg_fn.fusable)
        out = self.msg_fn(node_parts, edge_parts, recv, send, edge_mask,
                          seg if fused else None, in_degree)
        agg = out if fused else self._aggregate(out, recv, n_nodes,
                                                edge_mask)
        return self.update_fn(torch.cat([x, agg], -1), node_mask)

    def _aggregate(self, msgs, recv, n_nodes, edge_mask):
        if self.aggr == "add":
            return masked_segment_sum(msgs, recv, n_nodes, edge_mask)
        return masked_segment_mean(msgs, recv, n_nodes, edge_mask)

    def _ogb(self, x, recv, send, identifiers, edge_features, node_mask,
             edge_mask, seg):
        """The ``ogb`` kind (reference ``gsn_tpu/nn/filters.py:485-559``).
        With ``seg`` and add aggregation the message runs K1/K2 (the
        reference's slab path: ``pe = ids + e`` first, then the sender
        row added inside the kernel); otherwise per edge,
        ``relu((x_j + ids) + e)`` and a masked segment sum."""
        ids = (identifiers.to(torch.float32) if self.use_ids else None)
        ef = edge_features if self.use_edge_features else None
        # self message and the kernel's sender side: x, plus the
        # node-level ids at global scope
        self_msg = x
        if ids is not None and self.id_scope == "global":
            self_msg = x + ids
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
            b1 = torch.zeros(dm, dtype=torch.float32, device=x.device)
            agg = edge_message_aggregate(None, self_msg, pe, b1, seg, "relu")
        else:
            m = self_msg[send]
            if ids is not None and self.id_scope == "local":
                m = m + ids
            if ef is not None:
                m = m + ef
            agg = self._aggregate(torch.relu(m), recv, x.shape[0],
                                  edge_mask)
        fac = 1.0 + self.eps if hasattr(self, "eps") else 1.0
        return self.update_fn(fac * self_msg + agg, node_mask)
