"""Discrete-feature embeddings (counterpart of ``gsn_tpu/nn/embedding.py``,
reference ``utils_graph_learning.py:44-260``).

Kinds (reference ``gsn_tpu/nn/embedding.py:197-221``):

- ``zero_encoder``: zeros of width d_out
- ``linear``: one dense layer over the float input (``Dense_0``)
- ``mlp``: a one-hidden-layer MLP over the float input (``MLP_0``, its
  BN masked by the caller's row mask)
- ``one_hot_encoder``: per-column one-hot concat (vocab sizes d_in)
- ``embedding``: per-column tables, summed or concatenated
- ``atom_one_hot_encoder`` / ``bond_one_hot_encoder``: one-hots over the
  OGB atom / bond vocabularies
- ``atom_encoder`` / ``bond_encoder``: OGB-style summed tables over the
  9 atom / 3 bond fields
- ``None``: passthrough (as float)

The OGB kinds read the first two fields only when ``features_scope`` is
not ``"full"``.  ``CentralEncoder`` is the gin message's self-loop
feature (reference ``gsn_tpu/nn/embedding.py:227-262``).

A table lookup's backward sums each table row's gradient rows in one
fixed order (``ops.segment.table_lookup``: a one-hot product):
``nn.Embedding``'s backward accumulates them with float atomics on the
card, which made two runs of one seed part.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from gsn_tpu_torch.ops.segment import table_lookup
from .mlp import MLP

# ogb.utils.features allowable-feature vocabulary sizes
ATOM_FEATURE_DIMS = [119, 4, 12, 12, 10, 6, 6, 2, 2]
BOND_FEATURE_DIMS = [5, 6, 2]
# the OGB kinds: summed tables over the standard feature vocabularies
OGB_TABLES = {"atom_encoder": ATOM_FEATURE_DIMS,
              "bond_encoder": BOND_FEATURE_DIMS}
# the OGB one-hot kinds: one-hots over the same vocabularies
OGB_ONE_HOTS = {"atom_one_hot_encoder": ATOM_FEATURE_DIMS,
                "bond_one_hot_encoder": BOND_FEATURE_DIMS}


def _as_2d(x: torch.Tensor) -> torch.Tensor:
    return x[:, None] if x.dim() == 1 else x


class MultiEmbedding(nn.Module):
    """Per-column embedding tables ``embed_i`` with sum or concat
    aggregation (reference multi_embedding)."""

    def __init__(self, vocab_sizes: Sequence[int], d_out: int,
                 aggr: str = "concat", zeros_init: bool = False):
        super().__init__()
        if aggr not in ("concat", "sum"):
            raise NotImplementedError(f"multi embedding aggr {aggr!r}")
        self.aggr = aggr
        self.num_columns = len(vocab_sizes)
        for i, v in enumerate(vocab_sizes):
            emb = nn.Embedding(v, d_out)
            emb.zeros_init = zeros_init
            setattr(self, f"embed_{i}", emb)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _as_2d(x).long()
        outs = [table_lookup(getattr(self, f"embed_{i}").weight, x[:, i])
                for i in range(self.num_columns)]
        if self.aggr == "concat":
            return torch.cat(outs, dim=1)
        return sum(outs)


def one_hot_concat(x: torch.Tensor,
                   vocab_sizes: Sequence[int]) -> torch.Tensor:
    """Per-column one-hot concat (reference one_hot_encoder)."""
    x = _as_2d(x).long()
    return torch.cat([F.one_hot(x[:, i], v).to(torch.float32)
                      for i, v in enumerate(vocab_sizes)], dim=1)


class DiscreteEmbedding(nn.Module):
    """Uniform categorical/dense feature encoder (see module docstring).
    The ``embedding`` and OGB table kinds hold their tables in
    ``MultiEmbedding_0``, ``linear`` its layer in ``Dense_0`` and ``mlp``
    its MLP in ``MLP_0``: the reference package's parameter paths.
    ``features_scope`` picks the OGB kinds' fields."""

    KINDS = ("zero_encoder", "linear", "mlp", "one_hot_encoder",
             "embedding", "atom_one_hot_encoder", "bond_one_hot_encoder",
             "atom_encoder", "bond_encoder", "None")

    def __init__(self, kind: str, d_in_features: int,
                 d_in_encoder: Optional[Sequence[int]],
                 d_out_encoder: Optional[int], aggr: str = "concat",
                 zeros_init: bool = False, features_scope: str = "full",
                 activation_mlp: str = "elu", bn_mlp: bool = False):
        super().__init__()
        if kind not in self.KINDS:
            raise NotImplementedError(f"encoder {kind!r}")
        self.kind = kind
        self.d_in_features = d_in_features
        self.d_in_encoder = list(d_in_encoder or [])
        self.d_out_encoder = d_out_encoder
        self.aggr = aggr
        ogb = {**OGB_TABLES, **OGB_ONE_HOTS}
        self.ogb_dims = None
        if kind in ogb:
            self.ogb_dims = (ogb[kind] if features_scope == "full"
                             else ogb[kind][:2])
        if kind == "embedding":
            self.MultiEmbedding_0 = MultiEmbedding(
                self.d_in_encoder, d_out_encoder, aggr, zeros_init)
        elif kind in OGB_TABLES:
            self.MultiEmbedding_0 = MultiEmbedding(self.ogb_dims,
                                                   d_out_encoder, "sum")
        elif kind == "linear":
            self.Dense_0 = nn.Linear(d_in_features, d_out_encoder)
        elif kind == "mlp":
            self.MLP_0 = MLP(d_in_features, d_out_encoder, (d_out_encoder,),
                             activation_mlp, bn_mlp)

    @property
    def d_out(self) -> int:
        if self.kind in ("zero_encoder", "linear", "mlp") or \
                self.kind in OGB_TABLES:
            return self.d_out_encoder
        if self.kind == "one_hot_encoder":
            return sum(self.d_in_encoder)
        if self.kind in OGB_ONE_HOTS:
            return sum(self.ogb_dims)
        if self.kind == "embedding":
            return (len(self.d_in_encoder) * self.d_out_encoder
                    if self.aggr == "concat" else self.d_out_encoder)
        return self.d_in_features

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``mask``: the rows' validity, read by the ``mlp`` kind's BN."""
        x = _as_2d(x)
        if self.kind == "zero_encoder":
            return torch.zeros(x.shape[0], self.d_out_encoder,
                               dtype=torch.float32, device=x.device)
        if self.kind == "linear":
            return self.Dense_0(x.to(torch.float32))
        if self.kind == "mlp":
            return self.MLP_0(x.to(torch.float32), mask)
        if self.kind == "one_hot_encoder":
            return one_hot_concat(x, self.d_in_encoder)
        if self.kind in OGB_ONE_HOTS:
            return one_hot_concat(x, self.ogb_dims)
        if self.kind == "embedding" or self.kind in OGB_TABLES:
            return self.MultiEmbedding_0(x)
        return x.to(torch.float32)


class CentralEncoder(nn.Module):
    """The gin message's dummy self-loop feature (reference
    ``gsn_tpu/nn/embedding.py:227-262``, ``central_encoder``).

    ``forward(x_nb [E, d_ef], num_nodes)`` returns ``(x_central [N,
    d_out], x_nb)``: for one-hot kinds with ``extend`` the neighbours'
    rows get a zero column prepended and the central nodes the one-hot
    of that new category (``d_out = d_ef + 1``); for embedding kinds
    with ``extend`` every central node gets the learned row ``central``
    [1, d_ef] (xavier-uniform); otherwise the central features are
    zeros."""

    def __init__(self, nb_encoder_kind: str, d_ef: int, extend: bool = True):
        super().__init__()
        self.one_hot = "one_hot_encoder" in nb_encoder_kind
        self.extend = extend
        self.d_ef = d_ef
        if extend and not self.one_hot:
            self.central = nn.Parameter(torch.zeros(1, d_ef))

    @property
    def d_out(self) -> int:
        return self.d_ef + 1 if self.one_hot and self.extend else self.d_ef

    def forward(self, x_nb: torch.Tensor, num_nodes: int):
        if self.one_hot and self.extend:
            zero_col = x_nb.new_zeros(x_nb.shape[0], 1)
            x_nb = torch.cat([zero_col, x_nb], dim=1)
            x_central = torch.zeros(num_nodes, self.d_ef + 1,
                                    dtype=torch.float32, device=x_nb.device)
            x_central[:, 0] = 1.0
        elif self.extend:
            x_central = self.central.expand(num_nodes, -1)
        else:
            x_central = torch.zeros(num_nodes, self.d_out,
                                    dtype=torch.float32, device=x_nb.device)
        return x_central, x_nb
