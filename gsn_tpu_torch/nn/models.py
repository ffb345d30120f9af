"""Model assemblies (counterpart of ``gsn_tpu/nn/models.py``).

Ported so far, in f32: ``GNNSubstructures`` (reference
``models_graph_classification.py:15-247``) for the sparse GSN/MPNN model
names, ``GNN_OGB`` (reference
``models_graph_classification_ogb_original.py:17-268``, with or without
the virtual node) for the ``*_edge_sparse_ogb`` names, and
``NodeDropout``.  ``MLPSubstructures``, random features and the bf16
compute dtype raise until a later slice ports them.  (The DGN model is
``nn/dgn.py``.)

Dropout draws its masks from the ``torch.Generator`` the caller passes
to ``forward`` (the trainer's seeded generator on the batch's device),
so a seed fixes them.  They are not the reference's masks: JAX's
threefry and PyTorch's generators give different bits.
"""

from __future__ import annotations

from typing import Optional

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


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout: keep each element with probability 1 - rate and
    scale it by 1/(1 - rate); identity outside training or at rate 0."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.empty_like(x).bernoulli_(keep, generator=generator)
    return torch.where(mask.bool(), x / keep, torch.zeros_like(x))


class NodeDropout(nn.Module):
    """Dropout over node rows (reference ``gsn_tpu/nn/models.py``
    ``NodeDropout``).  The reference's edge-partition fold and its
    ``rbg`` bit generator belong to its sharded TPU path; here the mask
    comes from the generator passed in."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        return dropout(x, self.rate, self.training, generator)


def _pool_fn(readout: str):
    if readout == "sum":
        return global_add_pool
    if readout == "mean":
        return global_mean_pool
    raise ValueError(f"invalid readout {readout!r}")


def _make_pool(readout: str, data: GraphBatch):
    """Node-level pooling closure over the batch's graph offsets (the
    pool kernel path; padding nodes lie outside every graph)."""
    fn = _pool_fn(readout)
    return lambda x: fn(x, data.graph_ptr)


def edge_segments(data: GraphBatch) -> EdgeSegments:
    """The kernels' view of a batch's real edges."""
    send = data.edge_index[1 - data.select, :data.num_real_edges]
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
        if c.random_features:
            raise NotImplementedError("random_features is not ported yet")
        if c.compute_dtype:
            raise NotImplementedError(
                f"compute_dtype {c.compute_dtype!r}: the port runs f32 only")
        L = len(c.d_out)
        self.act = choose_activation(c.activation)
        self.use_degrees = any(c.degree_as_tag)
        if self.use_degrees:
            self.degree_encoder = DiscreteEmbedding(
                c.degree_embedding, 1, c.d_degree, c.d_out_degree_embedding,
                aggr=c.multi_embedding_aggr)
        self.input_node_encoder = DiscreteEmbedding(
            c.input_node_encoder, c.in_features, c.d_in_node_encoder,
            c.d_out_node_encoder, aggr=c.multi_embedding_aggr)
        num_id_enc = L if c.inject_ids else 1
        num_ef_enc = L if c.inject_edge_features else 1
        d_id = 0
        if c.uses_ids:
            for j in range(num_id_enc):
                setattr(self, f"id_encoder_{j}", DiscreteEmbedding(
                    c.id_embedding, len(c.d_in_id), c.d_in_id,
                    c.d_out_id_embedding, aggr=c.multi_embedding_aggr))
            d_id = self.id_encoder_0.d_out
        d_ef = []
        if c.uses_edge_features:
            for j in range(num_ef_enc):
                enc = DiscreteEmbedding(
                    c.edge_encoder, c.in_edge_features, c.d_in_edge_encoder,
                    c.d_out_edge_encoder[j], aggr=c.multi_embedding_aggr)
                setattr(self, f"edge_encoder_{j}", enc)
                d_ef.append(enc.d_out)
        d_deg = self.degree_encoder.d_out if self.use_degrees else 0

        widths = [self.input_node_encoder.d_out]
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
                bn_mlp=c.bn_mlp))
            if c.bn[i]:
                setattr(self, f"bn_{i}", MaskedBatchNorm(c.d_out[i]))
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
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        c = self.cfg
        if data.flow != c.flow:
            raise ValueError(f"batch built for flow {data.flow!r}, model "
                             f"uses {c.flow!r}")
        nm, em = data.node_mask, data.edge_mask
        num_graphs = data.num_graph_slots
        pool = _make_pool(c.readout, data)
        seg = edge_segments(data)
        degrees = (self.degree_encoder(data.degrees)
                   if self.use_degrees else None)
        x = self.input_node_encoder(data.x)
        x_interm = [x]
        for i in range(len(c.d_out)):
            conv = getattr(self, f"conv_{i}")
            ids_i = ef_i = None
            if conv.use_ids:
                ids_i = getattr(self, "id_encoder_"
                                f"{i if c.inject_ids else 0}")(
                                    data.identifiers)
            if conv.use_edge_features:
                if data.edge_features is None:
                    raise ValueError(f"{c.model_name} needs edge features")
                ef_i = getattr(self, "edge_encoder_"
                               f"{i if c.inject_edge_features else 0}")(
                                   data.edge_features)
            x = conv(x, data.edge_index, ids_i, degrees, ef_i, nm, em,
                     seg, data.in_degree)
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
        if c.compute_dtype:
            raise NotImplementedError(
                f"compute_dtype {c.compute_dtype!r}: the port runs f32 only")
        L = len(c.d_out)
        self.act = choose_activation(c.activation)
        self.use_degrees = any(c.degree_as_tag)
        if self.use_degrees:
            self.degree_encoder = DiscreteEmbedding(
                c.degree_embedding, 1, c.d_degree, c.d_out_degree_embedding,
                aggr=c.multi_embedding_aggr)
        self.input_node_encoder = DiscreteEmbedding(
            c.input_node_encoder, c.in_features, c.d_in_node_encoder,
            c.d_out_node_encoder, aggr=c.multi_embedding_aggr)
        with_ids = c.model_name == "GSN_edge_sparse_ogb"
        d_id = 0
        if with_ids:
            for j in range(L if c.inject_ids else 1):
                setattr(self, f"id_encoder_{j}", DiscreteEmbedding(
                    c.id_embedding, len(c.d_in_id), c.d_in_id,
                    c.d_out_id_embedding, aggr=c.multi_embedding_aggr))
            d_id = self.id_encoder_0.d_out
        for j in range(L):
            setattr(self, f"edge_encoder_{j}", DiscreteEmbedding(
                c.edge_encoder, c.in_edge_features, c.d_in_edge_encoder,
                c.d_out_edge_encoder[j], aggr=c.multi_embedding_aggr))
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
                bn_mlp=c.bn_mlp, train_eps=c.train_eps[i]))
            if c.bn[i]:
                setattr(self, f"bn_{i}", MaskedBatchNorm(c.d_out[i]))
            if c.vn and i < L - 1:
                setattr(self, f"mlp_vn_{i}", MLP(
                    d_x, c.d_out_vn[i], tuple(c.d_h[i]), c.activation_mlp,
                    c.bn_mlp))
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
        pool = _make_pool(c.readout, data)
        vn_pool = _make_pool(c.vn_pooling, data)
        seg = edge_segments(data)
        degrees = (self.degree_encoder(data.degrees)
                   if self.use_degrees else None)
        x = self.input_node_encoder(data.x)
        n_nodes = x.shape[0]
        if c.vn:
            vn = self.vn_encoder(torch.zeros(
                data.num_graph_slots, 1, dtype=torch.long, device=x.device))

        x_interm = [x]
        for i in range(L):
            conv = getattr(self, f"conv_{i}")
            ids_i = ef_i = None
            if conv.use_ids:
                ids_i = getattr(self, "id_encoder_"
                                f"{i if c.inject_ids else 0}")(
                                    data.identifiers)
            if data.edge_features is not None:
                ef_i = getattr(self, f"edge_encoder_{i}")(
                    data.edge_features)
            h = x_interm[i]
            if c.vn:
                h = h + broadcast_graph_to_nodes(vn, data.graph_ptr,
                                                 n_nodes)
                x_interm[i] = h
            x = conv(h, data.edge_index, ids_i, degrees, ef_i, nm, em, seg)
            if c.bn[i]:
                x = getattr(self, f"bn_{i}")(x, nm)
            # reference :242-245: no activation on the last conv layer
            if i < L - 1:
                x = self.act(x)
            x = dropout(x, c.dropout_features[i], self.training, generator)
            if c.residual:
                x = x + x_interm[-1]
            x_interm.append(x)

            if c.vn and i < L - 1:
                vn = getattr(self, f"mlp_vn_{i}")(
                    vn_pool(x_interm[i]) + vn, data.graph_mask)
                vn_post = dropout(self.act(vn), c.dropout_features[i],
                                  self.training, generator)
                vn = vn + vn_post if c.residual else vn_post

        prediction = torch.zeros_like(x_interm[-1])
        for i, xi in enumerate(x_interm):
            if c.final_projection[i]:
                prediction = prediction + xi
        return self.lin_proj(pool(prediction))


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
    elif cfg.model_name in SPARSE_MODELS:
        model = GNNSubstructures(cfg)
    else:
        raise NotImplementedError(
            f"model {cfg.model_name!r} is not ported yet")
    init_parameters(model, generator)
    return model
