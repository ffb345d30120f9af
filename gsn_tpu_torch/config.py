"""Experiment/model configuration schema (a copy of
``gsn_tpu/config.py``, so both packages read one set of knobs).

This replaces the reference's argparse + ``process_arguments`` broadcast
pass (``utils.py:35-194``, ``main.py:501-680``): a dataclass holds every
knob, and ``finalize()`` performs the same scalar->per-layer list
broadcasting so models receive fully-resolved per-layer hyperparameters.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional


@dataclasses.dataclass
class GSNConfig:
    # ---- architecture selection
    model_name: str = "GSN_sparse"     # GSN_sparse | GSN_edge_sparse |
    #                                    MPNN_sparse | MPNN_edge_sparse |
    #                                    GSN_edge_sparse_ogb | MPNN_edge_sparse_ogb | MLP
    num_layers: int = 2
    d_out: Any = 16                    # scalar -> broadcast per layer
    d_msg: Any = None                  # None -> d_out; -1 -> d_in (per ref)
    d_h: Any = None                    # scalar or None
    num_mlp_layers: int = 2
    out_features: int = 2

    # ---- message passing semantics (defaults = reference CLI defaults,
    # main.py:606-635)
    msg_kind: str = "general"          # general | gin | ogb
    id_scope: str = "local"            # global (GSN-v) | local (GSN-e)
    aggr: str = "add"
    flow: str = "source_to_target"

    # ---- encoders
    input_node_encoder: str = "None"
    d_out_node_encoder: Optional[int] = None
    edge_encoder: str = "None"
    d_out_edge_encoder: Any = None
    id_embedding: str = "one_hot_encoder"
    d_out_id_embedding: Optional[int] = None
    degree_embedding: str = "one_hot_encoder"
    d_out_degree_embedding: Optional[int] = None
    input_vn_encoder: str = "one_hot_encoder"
    d_out_vn_encoder: Optional[int] = None
    d_out_vn: Any = None
    multi_embedding_aggr: str = "sum"
    extend_dims: bool = True
    features_scope: str = "full"

    # ---- feature injection
    inject_ids: bool = False
    inject_degrees: bool = False
    inject_edge_features: bool = True
    degree_as_tag: Any = False
    retain_features: Any = False
    random_features: bool = False

    # ---- normalization / regularization / head
    bn: Any = True
    bn_mlp: bool = True
    activation_mlp: str = "relu"
    activation: str = "relu"
    final_projection: Any = (True,)
    jk_mlp: bool = False
    dropout_features: Any = 0.0
    readout: str = "sum"
    train_eps: Any = False
    vn: bool = False
    vn_pooling: str = "sum"
    residual: bool = False
    bn_axis_name: Any = None   # set inside shard_map for cross-replica BN
    compute_dtype: Any = None  # 'bfloat16' halves HBM traffic, 2x MXU
    dropout_rng: str = "threefry"  # 'rbg': hardware bit generator for
    #                                 node-level dropout masks (cheaper)

    # ---- data-dependent dims (filled by the pipeline)
    in_features: int = 1
    in_edge_features: Optional[int] = None
    d_in_node_encoder: Optional[List[int]] = None
    d_in_edge_encoder: Optional[List[int]] = None
    d_in_id: Optional[List[int]] = None   # per-column id vocab sizes
    d_degree: Optional[List[int]] = None  # degree vocab sizes

    _finalized: bool = False

    def finalize(self) -> "GSNConfig":
        """Broadcast scalar hyperparameters to per-layer lists, matching
        reference utils.py:94-161."""
        if self._finalized:
            return self
        c = dataclasses.replace(self)
        L = c.num_layers

        if c.inject_degrees:
            c.degree_as_tag = [bool(c.degree_as_tag)] * L
        else:
            c.degree_as_tag = [bool(c.degree_as_tag)] + [False] * (L - 1)
        c.retain_features = [bool(c.retain_features)] + [True] * (L - 1)

        if c.d_msg == -1:
            c.d_msg = [None] * L
        elif c.d_msg is None:
            c.d_msg = [c.d_out] * L
        elif not isinstance(c.d_msg, (list, tuple)):
            c.d_msg = [c.d_msg] * L

        if c.d_h is None:
            c.d_h = [[c.d_out] * (c.num_mlp_layers - 1)] * L
        elif not isinstance(c.d_h, (list, tuple)):
            c.d_h = [[c.d_h] * (c.num_mlp_layers - 1)] * L

        if c.d_out_edge_encoder is None:
            c.d_out_edge_encoder = [c.d_out] * L
        elif not isinstance(c.d_out_edge_encoder, (list, tuple)):
            c.d_out_edge_encoder = [c.d_out_edge_encoder] * L

        if c.d_out_node_encoder is None:
            c.d_out_node_encoder = c.d_out
        if c.d_out_id_embedding is None:
            c.d_out_id_embedding = c.d_out
        if c.d_out_degree_embedding is None:
            c.d_out_degree_embedding = c.d_out

        if c.vn:
            if c.d_out_vn_encoder is None:
                c.d_out_vn_encoder = c.d_out
            if c.d_out_vn is None:
                c.d_out_vn = [c.d_out] * (L - 1)
            elif not isinstance(c.d_out_vn, (list, tuple)):
                c.d_out_vn = [c.d_out_vn] * (L - 1)

        c.d_out = [c.d_out] * L if not isinstance(c.d_out, (list, tuple)) \
            else list(c.d_out)
        c.train_eps = [bool(c.train_eps)] * L \
            if not isinstance(c.train_eps, (list, tuple)) else list(c.train_eps)

        fp = list(c.final_projection) \
            if isinstance(c.final_projection, (list, tuple)) \
            else [c.final_projection]
        if len(fp) == 1:
            # reference utils.py:157-158: last projection always True
            fp = [bool(fp[0])] * L + [True]
        c.final_projection = fp

        c.bn = [bool(c.bn)] * L if not isinstance(c.bn, (list, tuple)) \
            else list(c.bn)
        if not isinstance(c.dropout_features, (list, tuple)):
            c.dropout_features = [c.dropout_features] * (L + 1)

        if not c.degree_as_tag[0]:
            c.degree_embedding = "None"

        c._finalized = True
        return c

    @property
    def uses_edge_features(self) -> bool:
        return self.model_name in {"GSN_edge_sparse", "MPNN_edge_sparse",
                                   "GSN_edge_sparse_ogb",
                                   "MPNN_edge_sparse_ogb"}

    @property
    def uses_ids(self) -> bool:
        return self.model_name in {"GSN_sparse", "GSN_edge_sparse",
                                   "GSN_edge_sparse_ogb"}
