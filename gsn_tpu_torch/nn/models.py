"""Model assemblies (counterpart of ``gsn_tpu/nn/models.py``).

``GNNSubstructures`` (reference
``models_graph_classification.py:15-247``) for the sparse GSN/MPNN model
names, with random features or without, ``GNN_OGB`` (reference
``models_graph_classification_ogb_original.py:17-268``, with or without
the virtual node) for the ``*_edge_sparse_ogb`` names,
``MLPSubstructures`` (reference ``models_graph_classification_mlp.py``)
for the ``MLP`` name, and ``NodeDropout``; each in f32 or with
``compute_dtype="bfloat16"``.  In
bf16, as in the reference (``gsn_tpu/nn/models.py:87-114, 154-157,
194-201, 276-289, 320-328, 385-390``), node rows, ids, edge features
and the virtual node travel in bf16 from the encoders on, pooled rows
and the head are f32, BN statistics f32, and the parameters stay f32
(the master copy the optimizer updates).  (The DGN model is
``nn/dgn.py``.)

Dropout draws its masks, and random features their uniform [0, 1)
columns, from the ``torch.Generator`` the caller passes to ``forward``
(the trainer's seeded generator on the batch's device), so a seed fixes
them.  They are not the reference's draws: JAX's threefry and PyTorch's
generators give different bits.  An
edge-partitioned rank passes ``DropoutStreams``: node rows draw from its
own stream, graph-level rows (replicated on every rank) from one that
all ranks share, the counterpart of the reference's
``fold_in(key, axis_index(ep_axis))`` for node dropout only
(``gsn_tpu/nn/models.py:53-75``).

On an edge-partitioned shard (``GraphBatch.ep_axis``) the pools sum the
ranks' partial per-graph sums, the layers all-gather their sender side,
and BN statistics are summed over ``cfg.bn_axis_name``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from gsn_tpu_torch.config import GSNConfig
from gsn_tpu_torch.graphs.container import GraphBatch
from gsn_tpu_torch.ops.cuda.slab_message import EdgeSegments
from gsn_tpu_torch.ops.norm import MaskedBatchNorm
from gsn_tpu_torch.ops.segment import (broadcast_graph_to_nodes,
                                       global_add_pool, global_mean_pool)
from .embedding import DiscreteEmbedding
from .filters import GSNLayer
from .init import init_parameters
from .mlp import MLP, choose_activation


class DropoutStreams(NamedTuple):
    """An edge-partitioned rank's dropout generators: ``graph`` seeded
    alike on every rank, ``node`` this rank's own."""
    graph: torch.Generator
    node: torch.Generator


def _stream(generator, node_rows: bool):
    if isinstance(generator, DropoutStreams):
        return generator.node if node_rows else generator.graph
    return generator


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator=None, node_rows: bool = False) -> torch.Tensor:
    """Inverted dropout: keep each element with probability 1 - rate and
    scale it by 1/(1 - rate); identity outside training or at rate 0.
    ``generator``: a ``torch.Generator``, or ``DropoutStreams`` whose
    node stream serves ``node_rows`` and whose graph stream the rest."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.empty_like(x).bernoulli_(
        keep, generator=_stream(generator, node_rows))
    return torch.where(mask.bool(), x / keep, torch.zeros_like(x))


class NodeDropout(nn.Module):
    """Dropout over node rows (reference ``gsn_tpu/nn/models.py``
    ``NodeDropout``): under edge partitioning its masks come from the
    rank's own stream of ``DropoutStreams``, so the ranks' blocks draw
    different masks.  The reference's ``rbg`` bit generator belongs to
    its TPU path; here the mask comes from the generator passed in."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        return dropout(x, self.rate, self.training, generator,
                       node_rows=True)


def _pool_fn(readout: str):
    if readout == "sum":
        return global_add_pool
    if readout == "mean":
        return global_mean_pool
    raise ValueError(f"invalid readout {readout!r}")


def _make_pool(readout: str, data: GraphBatch,
               compute_dtype: Optional[torch.dtype] = None):
    """Node-level pooling closure over the batch's graph offsets (the
    pool kernel path; padding nodes lie outside every graph), summed
    over the ranks of an edge-partitioned shard.  With a compute dtype
    the node rows are rounded to it first, as on the reference's slab
    layout; the pooled rows are f32."""
    fn = _pool_fn(readout)
    if compute_dtype is None:
        return lambda x: fn(x, data.graph_ptr, data.ep_axis)
    return lambda x: fn(x.to(compute_dtype), data.graph_ptr, data.ep_axis)


def compute_dtype_of(cfg) -> Optional[torch.dtype]:
    """The config's compute dtype: None (f32) or ``torch.bfloat16``."""
    if cfg.compute_dtype is None:
        return None
    if cfg.compute_dtype == "bfloat16":
        return torch.bfloat16
    raise ValueError(f"compute_dtype {cfg.compute_dtype!r}: the port runs "
                     f"None (f32) or 'bfloat16'")


def edge_segments(data: GraphBatch) -> EdgeSegments:
    """The kernels' view of a batch's real edges: the sender of every
    edge slot (padding slots' point at node slot 0, outside every
    segment), so its shape is the batch's caps', whatever its real edge
    count."""
    send = data.edge_index[1 - data.select]
    return EdgeSegments(data.recv_ptr, send.contiguous(), data.send_ptr,
                        data.send_perm)


class GNNSubstructures(nn.Module):
    """Main GSN model.

    Layer i is a GSN filter iff (i == 0 or inject_ids) and the model is a
    GSN variant; later layers degrade to plain MPNN when ids are not
    injected (reference :147-155).  Jumping-knowledge projections of
    pooled intermediate representations are summed into the prediction,
    with dropout applied after each projection (reference :236-242).
    Submodule names follow the reference package's parameter paths.
    """

    def __init__(self, cfg: GSNConfig):
        super().__init__()
        c = self.cfg = cfg
        cdt = self.cdt = compute_dtype_of(c)
        L = len(c.d_out)
        self.act = choose_activation(c.activation)
        enc = _encoder_factory(c)
        self.use_degrees = any(c.degree_as_tag)
        if self.use_degrees:
            self.degree_encoder = enc(c.degree_embedding, 1, c.d_degree,
                                      c.d_out_degree_embedding)
        self.input_node_encoder = enc(
            c.input_node_encoder, c.in_features, c.d_in_node_encoder,
            c.d_out_node_encoder, features_scope=c.features_scope)
        num_id_enc = L if c.inject_ids else 1
        num_ef_enc = L if c.inject_edge_features else 1
        d_id = 0
        if c.uses_ids:
            for j in range(num_id_enc):
                setattr(self, f"id_encoder_{j}", enc(
                    c.id_embedding, len(c.d_in_id), c.d_in_id,
                    c.d_out_id_embedding))
            d_id = self.id_encoder_0.d_out
        d_ef = []
        if c.uses_edge_features:
            for j in range(num_ef_enc):
                e = enc(c.edge_encoder, c.in_edge_features,
                        c.d_in_edge_encoder, c.d_out_edge_encoder[j],
                        features_scope=c.features_scope)
                setattr(self, f"edge_encoder_{j}", e)
                d_ef.append(e.d_out)
        d_deg = self.degree_encoder.d_out if self.use_degrees else 0

        # random features: d_out[0] uniform columns after the encoder
        widths = [self.input_node_encoder.d_out
                  + (c.d_out[0] if c.random_features else 0)]
        for i in range(L):
            use_ids = ((i > 0 and c.inject_ids) or i == 0) and c.uses_ids
            use_efs = (((i > 0 and c.inject_edge_features) or i == 0)
                       and c.uses_edge_features)
            setattr(self, f"conv_{i}", GSNLayer(
                widths[-1], c.d_out[i], c.d_msg[i], tuple(c.d_h[i]),
                msg_kind=c.msg_kind, id_scope=c.id_scope, use_ids=use_ids,
                use_edge_features=use_efs, d_id=d_id,
                d_ef=d_ef[i if c.inject_edge_features else 0] if use_efs
                else 0,
                degree_as_tag=c.degree_as_tag[i], d_degree=d_deg,
                retain_features=c.retain_features[i], aggr=c.aggr,
                flow=c.flow, activation_mlp=c.activation_mlp,
                bn_mlp=c.bn_mlp, train_eps=c.train_eps[i],
                id_embedding_kind=c.id_embedding,
                edge_embedding_kind=c.edge_encoder,
                extend_dims=c.extend_dims, compute_dtype=cdt,
                bn_axis_name=c.bn_axis_name))
            if c.bn[i]:
                setattr(self, f"bn_{i}", MaskedBatchNorm(
                    c.d_out[i], axis_name=c.bn_axis_name))
            widths.append(c.d_out[i])
        for i, w in enumerate(widths):
            if not c.final_projection[i]:
                continue
            if c.jk_mlp:
                proj = MLP(w, c.out_features,
                           tuple(c.d_h[min(i, len(c.d_h) - 1)]),
                           c.activation_mlp, c.bn_mlp)
            else:
                proj = nn.Linear(w, c.out_features)
            setattr(self, f"lin_proj_{i}", proj)

    def forward(self, data: GraphBatch,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``noise``: the random features [N, d_out[0]] to use in place
        of a draw from ``generator`` (with ``random_features``)."""
        c = self.cfg
        if data.flow != c.flow:
            raise ValueError(f"batch built for flow {data.flow!r}, model "
                             f"uses {c.flow!r}")
        nm, em = data.node_mask, data.edge_mask
        num_graphs = data.num_graph_slots
        cdt = self.cdt
        pool = _make_pool(c.readout, data, cdt)
        seg = edge_segments(data)
        degrees = (self.degree_encoder(data.degrees, nm)
                   if self.use_degrees else None)
        x = self.input_node_encoder(data.x, nm)
        if c.random_features:
            # reference :212-214: uniform [0, 1) columns drawn each call
            if noise is None:
                noise = torch.rand(x.shape[0], c.d_out[0], device=x.device,
                                   generator=_stream(generator, True))
            x = torch.cat([x, noise.to(x.dtype)], dim=1)
        if cdt is not None:
            # node rows travel in the compute dtype from here on
            x = x.to(cdt)
        x_interm = [x]
        for i in range(len(c.d_out)):
            conv = getattr(self, f"conv_{i}")
            ids_i = ef_i = None
            if conv.use_ids:
                ids_i = getattr(self, "id_encoder_"
                                f"{i if c.inject_ids else 0}")(
                                    data.identifiers,
                                    em if c.id_scope == "local" else nm)
            if conv.use_edge_features:
                if data.edge_features is None:
                    raise ValueError(f"{c.model_name} needs edge features")
                ef_i = getattr(self, "edge_encoder_"
                               f"{i if c.inject_edge_features else 0}")(
                                   data.edge_features, em)
            if cdt is not None:
                # encoder outputs travel in the compute dtype
                ids_i = ids_i.to(cdt) if ids_i is not None else None
                ef_i = ef_i.to(cdt) if ef_i is not None else None
            x = conv(x, data.edge_index, ids_i, degrees, ef_i, nm, em,
                     seg, data.in_degree, data.ep_axis)
            if c.bn[i]:
                x = getattr(self, f"bn_{i}")(x, nm)
            x = self.act(x)
            x_interm.append(x)

        prediction = torch.zeros(num_graphs, c.out_features,
                                 dtype=torch.float32, device=x.device)
        for i, xi in enumerate(x_interm):
            if not c.final_projection[i]:
                continue
            xg = pool(xi)
            proj_fn = getattr(self, f"lin_proj_{i}")
            proj = (proj_fn(xg, data.graph_mask) if c.jk_mlp
                    else proj_fn(xg))
            proj = dropout(proj, c.dropout_features[i], self.training,
                           generator)
            prediction = prediction + proj
        return prediction


class GNN_OGB(nn.Module):
    """OGB model with virtual node (reference
    models_graph_classification_ogb_original.py:17-268).

    Each layer adds the graph's virtual node to its node rows (B4) and
    the sum is what the conv, the pool into the next virtual node and
    the residual read; then the ``ogb`` conv, BN, relu (not in the last
    layer) and node dropout.  Between layers the virtual node becomes
    ``Dropout(relu(MLP(sum_pool(h) + vn)))``, its MLP's BN over the real
    graph slots.  The readout is the pool of the summed
    ``final_projection`` layers, then ``lin_proj``.  Submodule names
    follow the reference package's parameter paths."""

    def __init__(self, cfg: GSNConfig):
        super().__init__()
        c = self.cfg = cfg
        cdt = self.cdt = compute_dtype_of(c)
        L = len(c.d_out)
        self.act = choose_activation(c.activation)
        enc = _encoder_factory(c)
        self.use_degrees = any(c.degree_as_tag)
        if self.use_degrees:
            self.degree_encoder = enc(c.degree_embedding, 1, c.d_degree,
                                      c.d_out_degree_embedding)
        self.input_node_encoder = enc(
            c.input_node_encoder, c.in_features, c.d_in_node_encoder,
            c.d_out_node_encoder, features_scope=c.features_scope)
        with_ids = c.model_name == "GSN_edge_sparse_ogb"
        d_id = 0
        if with_ids:
            for j in range(L if c.inject_ids else 1):
                setattr(self, f"id_encoder_{j}", enc(
                    c.id_embedding, len(c.d_in_id), c.d_in_id,
                    c.d_out_id_embedding))
            d_id = self.id_encoder_0.d_out
        for j in range(L):
            setattr(self, f"edge_encoder_{j}", enc(
                c.edge_encoder, c.in_edge_features, c.d_in_edge_encoder,
                c.d_out_edge_encoder[j], features_scope=c.features_scope))
        d_deg = self.degree_encoder.d_out if self.use_degrees else 0
        if c.vn:
            # zeros-init embedding of a single category (reference :77-86)
            self.vn_encoder = DiscreteEmbedding(
                c.input_vn_encoder, 1, [1], c.d_out_vn_encoder,
                aggr=c.multi_embedding_aggr, zeros_init=True)
            d_vn = self.vn_encoder.d_out

        widths = [self.input_node_encoder.d_out]
        for i in range(L):
            use_ids = ((i > 0 and c.inject_ids) or i == 0) and with_ids
            d_x = max(widths[-1], d_vn) if c.vn else widths[-1]
            setattr(self, f"conv_{i}", GSNLayer(
                d_x, c.d_out[i], c.d_msg[i], tuple(c.d_h[i]),
                msg_kind="ogb", id_scope=c.id_scope, use_ids=use_ids,
                use_edge_features=True, d_id=d_id,
                degree_as_tag=c.degree_as_tag[i], d_degree=d_deg,
                retain_features=c.retain_features[i], aggr=c.aggr,
                flow=c.flow, activation_mlp=c.activation_mlp,
                bn_mlp=c.bn_mlp, train_eps=c.train_eps[i],
                compute_dtype=cdt, bn_axis_name=c.bn_axis_name))
            if c.bn[i]:
                setattr(self, f"bn_{i}", MaskedBatchNorm(
                    c.d_out[i], axis_name=c.bn_axis_name))
            if c.vn and i < L - 1:
                setattr(self, f"mlp_vn_{i}", MLP(
                    d_x, c.d_out_vn[i], tuple(c.d_h[i]), c.activation_mlp,
                    c.bn_mlp, cdt))
                d_vn = c.d_out_vn[i]
            widths.append(c.d_out[i])
        self.lin_proj = nn.Linear(widths[-1], c.out_features)

    def forward(self, data: GraphBatch,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        c = self.cfg
        if data.flow != c.flow:
            raise ValueError(f"batch built for flow {data.flow!r}, model "
                             f"uses {c.flow!r}")
        nm, em = data.node_mask, data.edge_mask
        L = len(c.d_out)
        cdt = self.cdt
        pool = _make_pool(c.readout, data, cdt)
        # the reference's virtual-node pool takes no compute dtype: its
        # rows are already in it (gsn_tpu/nn/models.py:385-387)
        vn_pool = _make_pool(c.vn_pooling, data)
        seg = edge_segments(data)
        degrees = (self.degree_encoder(data.degrees, nm)
                   if self.use_degrees else None)
        x = self.input_node_encoder(data.x, nm)
        n_nodes = x.shape[0]
        if cdt is not None:
            # activations (x, vn) travel in the compute dtype
            x = x.to(cdt)
        if c.vn:
            vn = self.vn_encoder(torch.zeros(
                data.num_graph_slots, 1, dtype=torch.long, device=x.device))
            if cdt is not None:
                vn = vn.to(cdt)

        x_interm = [x]
        for i in range(L):
            conv = getattr(self, f"conv_{i}")
            ids_i = ef_i = None
            if conv.use_ids:
                ids_i = getattr(self, "id_encoder_"
                                f"{i if c.inject_ids else 0}")(
                                    data.identifiers,
                                    em if c.id_scope == "local" else nm)
            if data.edge_features is not None:
                ef_i = getattr(self, f"edge_encoder_{i}")(
                    data.edge_features, em)
            if cdt is not None:
                ids_i = ids_i.to(cdt) if ids_i is not None else None
                ef_i = ef_i.to(cdt) if ef_i is not None else None
            h = x_interm[i]
            if c.vn:
                h = h + broadcast_graph_to_nodes(vn, data.graph_ptr,
                                                 n_nodes)
                x_interm[i] = h
            x = conv(h, data.edge_index, ids_i, degrees, ef_i, nm, em, seg,
                     ep_axis=data.ep_axis)
            if c.bn[i]:
                x = getattr(self, f"bn_{i}")(x, nm)
            # reference :242-245: no activation on the last conv layer
            if i < L - 1:
                x = self.act(x)
            x = dropout(x, c.dropout_features[i], self.training, generator,
                        node_rows=True)
            if c.residual:
                x = x + x_interm[-1]
            x_interm.append(x)

            if c.vn and i < L - 1:
                vn = getattr(self, f"mlp_vn_{i}")(
                    vn_pool(x_interm[i]).to(vn.dtype) + vn, data.graph_mask)
                vn_post = dropout(self.act(vn), c.dropout_features[i],
                                  self.training, generator)
                vn = vn + vn_post if c.residual else vn_post

        prediction = torch.zeros_like(x_interm[-1])
        for i, xi in enumerate(x_interm):
            if c.final_projection[i]:
                prediction = prediction + xi
        return self.lin_proj(pool(prediction))


class MLPSubstructures(nn.Module):
    """The linear baseline with no message passing (reference
    ``models_graph_classification_mlp.py:13-176``, ``gsn_tpu/nn/
    models.py:403-450``): one edge MLP ``edge_mlp`` over ``cat(x_i, x_j,
    ids[, e])`` (the ids once per edge at local scope, at both endpoints
    at global scope), pooled per graph over the real edges, dropout and
    the ``head``.  The real edges are receiver-sorted, so each graph's
    edges are one contiguous range (from ``recv_ptr`` at the graph's
    first node): the pool is the pool kernel over those ranges.  It
    computes in f32 whatever the compute dtype, as the reference's."""

    def __init__(self, cfg: GSNConfig):
        super().__init__()
        c = self.cfg = cfg
        enc = _encoder_factory(c)
        self.input_node_encoder = enc(
            c.input_node_encoder, c.in_features, c.d_in_node_encoder,
            c.d_out_node_encoder)
        self.id_encoder = enc(c.id_embedding, len(c.d_in_id), c.d_in_id,
                              c.d_out_id_embedding)
        d_x, d_id = self.input_node_encoder.d_out, self.id_encoder.d_out
        d_in = 2 * d_x + (d_id if c.id_scope == "local" else 2 * d_id)
        if c.uses_edge_features:
            self.edge_encoder = enc(c.edge_encoder, c.in_edge_features,
                                    c.d_in_edge_encoder,
                                    c.d_out_edge_encoder[0])
            d_in += self.edge_encoder.d_out
        self.edge_mlp = MLP(d_in, c.d_out[0], tuple(c.d_h[0]),
                            c.activation_mlp, c.bn_mlp)
        self.head = nn.Linear(c.d_out[0], c.out_features)

    def forward(self, data: GraphBatch,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        c = self.cfg
        nm, em = data.node_mask, data.edge_mask
        x = self.input_node_encoder(data.x, nm)
        ids = self.id_encoder(data.identifiers,
                              em if c.id_scope == "local" else nm)
        recv, send = data.edge_index[0], data.edge_index[1]
        parts = [x[recv], x[send]]
        parts += ([ids] if c.id_scope == "local" else [ids[recv], ids[send]])
        if data.edge_features is not None and c.uses_edge_features:
            parts.append(self.edge_encoder(data.edge_features, em))
        h = self.edge_mlp(torch.cat(parts, -1), em)
        # each graph's real edges: from its first node's first edge
        edge_ptr = data.recv_ptr[data.graph_ptr.long()].contiguous()
        hg = _pool_fn(c.readout)(h, edge_ptr)
        hg = dropout(hg, c.dropout_features[0], self.training, generator)
        return self.head(hg)


def _encoder_factory(c):
    """``DiscreteEmbedding`` with the config's shared knobs."""
    def enc(kind, d_in_features, d_in_encoder, d_out_encoder, **kw):
        return DiscreteEmbedding(
            kind, d_in_features, d_in_encoder, d_out_encoder,
            aggr=c.multi_embedding_aggr, activation_mlp=c.activation_mlp,
            bn_mlp=c.bn_mlp, **kw)
    return enc


SPARSE_MODELS = {"GSN_sparse", "GSN_edge_sparse", "MPNN_sparse",
                 "MPNN_edge_sparse"}
OGB_MODELS = {"GSN_edge_sparse_ogb", "MPNN_edge_sparse_ogb"}


def build_model(cfg: GSNConfig,
                generator: Optional[torch.Generator] = None) -> nn.Module:
    """The finalized config's model on the CPU, its weights drawn from
    ``generator`` (the reference package's initializers)."""
    cfg = cfg.finalize()
    if cfg.model_name in OGB_MODELS:
        model = GNN_OGB(cfg)
    elif cfg.model_name == "MLP":
        model = MLPSubstructures(cfg)
    elif cfg.model_name in SPARSE_MODELS:
        model = GNNSubstructures(cfg)
    else:
        raise NotImplementedError(f"model {cfg.model_name!r}")
    init_parameters(model, generator)
    return model
