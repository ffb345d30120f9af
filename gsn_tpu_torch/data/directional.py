"""Directional-GSN data assembly (a copy of ``gsn_tpu/data/directional.py``,
reference ``directional_gsn/data/HIV.py``).

Builds the DGN "vector field" features: Laplacian eigenvector positional
encodings (``positional_encoding``, HIV.py:21-51) and/or substructure
counts / bond features (``HIVDGL.get_subgraphs/get_edge_feat``,
HIV.py:109-127), and filters out graphs with <= 5 nodes (HIV.py:65).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def laplacian_eig(edge_index: np.ndarray, num_nodes: int, k: int,
                  norm: str = "none") -> np.ndarray:
    """First k Laplacian eigenvectors (smallest real part), [n, k].

    Reference uses scipy ARPACK (``sp.linalg.eigs(L, k, which='SR',
    tol=1e-2)``); molecule graphs are tiny so a dense solve is both
    faster and more accurate here.  ``norm`` in {none, sym, walk}.
    """
    A = np.zeros((num_nodes, num_nodes))
    if edge_index.size:
        A[edge_index[0], edge_index[1]] = 1.0
    deg = A.sum(1).clip(1)
    if norm == "none":
        L = np.diag(deg) - A
    elif norm == "sym":
        d = deg ** -0.5
        L = np.eye(num_nodes) - (A * d[:, None]) * d[None, :]
    elif norm == "walk":
        L = np.eye(num_nodes) - A / deg[:, None]
    else:
        raise ValueError(f"unknown norm {norm!r}")
    vals, vecs = np.linalg.eig(L)
    order = np.argsort(vals.real)
    k = min(k, num_nodes)
    out = np.real(vecs[:, order[:k]]).astype(np.float32)
    if out.shape[1] < k:
        out = np.pad(out, ((0, 0), (0, k - out.shape[1])))
    return out


def assemble_directions(
    graphs: List[Dict],
    directions: Sequence[str] = ("subgraphs",),
    id_scope: str = "local",
    pos_enc_dim: int = 0,
    norm: str = "none",
    min_nodes: int = 5,
) -> List[Dict]:
    """Attach node_eig / edge_eig vector fields and drop tiny graphs.

    directions: any of 'eig' (Laplacian eigenvectors, k=4), 'subgraphs'
    (substructure counts from ``identifiers``), 'edge_feat' (bond
    features).  Node-level fields concatenate onto ``node_eig``,
    edge-level onto ``edge_eig`` (reference HIV.py:71-127).
    """
    out = []
    for g in graphs:
        n = g["x"].shape[0]
        if n <= min_nodes:
            continue
        g = dict(g)
        node_eig = None
        edge_eig = None
        for direction in directions:
            if direction == "eig":
                eig = laplacian_eig(g["edge_index"], n, 4, norm=norm)
                node_eig = (eig if node_eig is None
                            else np.concatenate([node_eig, eig], 1))
            elif direction == "subgraphs":
                counts = np.asarray(g["identifiers"], np.float32)
                if id_scope == "global":
                    node_eig = (counts if node_eig is None
                                else np.concatenate([node_eig, counts], 1))
                else:
                    edge_eig = (counts if edge_eig is None
                                else np.concatenate([edge_eig, counts], 1))
            elif direction == "edge_feat":
                ef = np.asarray(g["edge_features"], np.float32)
                edge_eig = (ef if edge_eig is None
                            else np.concatenate([edge_eig, ef], 1))
            else:
                raise NotImplementedError(
                    f"direction {direction!r} is not supported")
        if node_eig is not None:
            g["node_eig"] = node_eig.astype(np.float32)
        if edge_eig is not None:
            g["edge_eig"] = edge_eig.astype(np.float32)
        if pos_enc_dim > 0 and node_eig is not None:
            g["pos_enc_dim"] = pos_enc_dim
        out.append(g)
    return out
