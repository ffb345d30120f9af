"""Categorical encoding of structural identifiers and degrees.

Host-side numpy pass matching reference ``utils_encoding.py``:
``one_hot_unique`` builds a *dataset-wide* per-column vocabulary with
``np.unique`` (sorted order — a documented parity trap, SURVEY §7) and
rewrites every graph's columns as contiguous category indices;
``one_hot_max`` keeps values and just records ``max+1`` vocab sizes.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


class OneHotUnique:
    """Per-column contiguous relabel over the concatenated dataset."""

    def __init__(self, tensor_list: Sequence[np.ndarray]):
        cat = np.concatenate(tensor_list, axis=0)
        self.d: List[int] = []
        self.uniques: Dict[int, np.ndarray] = {}
        self._corrs: Dict[int, np.ndarray] = {}
        for col in range(cat.shape[1]):
            uniques, corrs = np.unique(cat[:, col], return_inverse=True)
            self.d.append(len(uniques))
            self.uniques[col] = uniques
            self._corrs[col] = corrs

    def fit(self, tensor_list: Sequence[np.ndarray]) -> List[np.ndarray]:
        pointer = 0
        out = []
        for t in tensor_list:
            n = t.shape[0]
            cols = [self._corrs[c][pointer:pointer + n][:, None]
                    for c in range(t.shape[1])]
            out.append(np.concatenate(cols, axis=1).astype(np.int64)
                       if cols else np.zeros((n, 0), np.int64))
            pointer += n
        return out

    def transform(self, t: np.ndarray) -> np.ndarray:
        """Encode unseen data via searchsorted into the stored vocab."""
        cols = []
        for c in range(t.shape[1]):
            idx = np.searchsorted(self.uniques[c], t[:, c])
            idx = np.clip(idx, 0, len(self.uniques[c]) - 1)
            cols.append(idx[:, None])
        return np.concatenate(cols, axis=1).astype(np.int64)


class OneHotMax:
    """Vocab size = max value + 1 per column; values pass through."""

    def __init__(self, tensor_list: Sequence[np.ndarray]):
        cat = np.concatenate(tensor_list, axis=0)
        self.d = [int(cat[:, i].max() + 1) for i in range(cat.shape[1])]

    def fit(self, tensor_list):
        return [t.astype(np.int64) for t in tensor_list]


_ENCODINGS = {"one_hot_unique": OneHotUnique, "one_hot_max": OneHotMax}


def encode(graphs: List[dict], id_encoding: str | None,
           degree_encoding: str | None = None):
    """Rewrite ``identifiers``/``degrees`` in-place to categorical indices.

    Returns (graphs, encoder_ids, d_id, encoder_degrees, d_degree),
    mirroring reference utils_encoding.py:8-34.
    """
    encoder_ids, d_id = None, None
    if graphs and "identifiers" in graphs[0]:
        d_id = [1] * graphs[0]["identifiers"].shape[1]
    if id_encoding is not None:
        ids = [g["identifiers"] for g in graphs]
        encoder_ids = _ENCODINGS[id_encoding](ids)
        for g, enc in zip(graphs, encoder_ids.fit(ids)):
            g["identifiers"] = enc
        d_id = encoder_ids.d

    encoder_degrees, d_degree = None, []
    if degree_encoding is not None:
        degs = [np.asarray(g["degrees"]).reshape(-1, 1) for g in graphs]
        encoder_degrees = _ENCODINGS[degree_encoding](degs)
        for g, enc in zip(graphs, encoder_degrees.fit(degs)):
            g["degrees"] = enc
        d_degree = encoder_degrees.d

    return graphs, encoder_ids, d_id, encoder_degrees, d_degree
