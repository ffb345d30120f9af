"""Discrete-feature embeddings (counterpart of ``gsn_tpu/nn/embedding.py``,
reference ``utils_graph_learning.py:44-260``).

Kinds ported so far:

- ``one_hot_encoder``: per-column one-hot concat (vocab sizes d_in)
- ``embedding``: per-column tables, summed or concatenated
- ``atom_encoder`` / ``bond_encoder``: OGB-style summed tables over the
  9 atom / 3 bond fields, or over the first two of each when
  ``features_scope`` is not ``"full"`` (reference
  ``gsn_tpu/nn/embedding.py:184-190, 216-221``)
- ``None``: passthrough (as float)

The other kinds of the reference package (``zero_encoder``, ``linear``,
``mlp``, the one-hot OGB encoders) raise until a later slice needs them.

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

# ogb.utils.features allowable-feature vocabulary sizes
ATOM_FEATURE_DIMS = [119, 4, 12, 12, 10, 6, 6, 2, 2]
BOND_FEATURE_DIMS = [5, 6, 2]
# the OGB kinds: summed tables over the standard feature vocabularies
OGB_TABLES = {"atom_encoder": ATOM_FEATURE_DIMS,
              "bond_encoder": BOND_FEATURE_DIMS}


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
    The ``embedding`` and OGB kinds hold their tables in
    ``MultiEmbedding_0``, the reference package's parameter path;
    ``features_scope`` picks the OGB kinds' fields."""

    KINDS = ("one_hot_encoder", "embedding", "atom_encoder",
             "bond_encoder", "None")

    def __init__(self, kind: str, d_in_features: int,
                 d_in_encoder: Optional[Sequence[int]],
                 d_out_encoder: Optional[int], aggr: str = "concat",
                 zeros_init: bool = False, features_scope: str = "full"):
        super().__init__()
        if kind not in self.KINDS:
            raise NotImplementedError(f"encoder {kind!r} is not ported yet")
        self.kind = kind
        self.d_in_features = d_in_features
        self.d_in_encoder = list(d_in_encoder or [])
        self.d_out_encoder = d_out_encoder
        self.aggr = aggr
        if kind == "embedding":
            self.MultiEmbedding_0 = MultiEmbedding(
                self.d_in_encoder, d_out_encoder, aggr, zeros_init)
        elif kind in OGB_TABLES:
            dims = OGB_TABLES[kind]
            if features_scope != "full":
                dims = dims[:2]
            self.MultiEmbedding_0 = MultiEmbedding(dims, d_out_encoder,
                                                   "sum")

    @property
    def d_out(self) -> int:
        if self.kind in OGB_TABLES:
            return self.d_out_encoder
        if self.kind == "one_hot_encoder":
            return sum(self.d_in_encoder)
        if self.kind == "embedding":
            return (len(self.d_in_encoder) * self.d_out_encoder
                    if self.aggr == "concat" else self.d_out_encoder)
        return self.d_in_features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _as_2d(x)
        if self.kind == "one_hot_encoder":
            return one_hot_concat(x, self.d_in_encoder)
        if self.kind == "embedding" or self.kind in OGB_TABLES:
            return self.MultiEmbedding_0(x)
        return x.to(torch.float32)
