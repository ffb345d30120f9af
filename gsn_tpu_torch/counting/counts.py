"""Per-node / per-edge subgraph-isomorphism orbit counts.

Semantics mirror the reference exactly
(``utils_graph_processing.py:103-179``):

- vertex counts: for every embedding of pattern H into host G, the count
  ``counts[host_node, vertex_orbit(pattern_node)]`` is incremented, then
  the whole matrix is divided by |Aut(H)|;
- edge counts: for every embedding and every *directed* pattern edge, the
  mapped directed host edge's ``counts[host_edge, edge_orbit]`` is
  incremented, then divided by |Aut(H)|.  The host edge_index is expected
  to contain both directions (as all reference datasets do).

Self-loops and parallel edges in the host are removed before matching
(host adjacency is a set structure, so parallel edges collapse; self
loops are skipped by ``build_adjacency``).

The enumeration backend is pluggable: the pure-Python VF2 oracle
(``gsn_tpu_torch.counting.vf2``) or the native C++ engine
(``gsn_tpu_torch.native``), selected automatically if built.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .orbits import PatternInfo
from .vf2 import (build_adjacency, build_directed_adjacency,
                  enumerate_directed_subgraph_isomorphisms,
                  enumerate_subgraph_isomorphisms)


def _enumerate(pattern: PatternInfo, edge_index: np.ndarray,
               num_nodes: int, induced: bool):
    edges = edge_index.T.tolist()
    if pattern.directed:
        h_out, h_in = build_directed_adjacency(num_nodes, edges)
        return enumerate_directed_subgraph_isomorphisms(
            pattern.out_adj, pattern.in_adj, pattern.num_vertices,
            h_out, h_in, num_nodes, induced)
    host_adj = build_adjacency(num_nodes, edges)
    return enumerate_subgraph_isomorphisms(
        pattern.adj, pattern.num_vertices, host_adj, num_nodes, induced)


def subgraph_isomorphism_vertex_counts(
    edge_index: np.ndarray,
    pattern: PatternInfo,
    induced: bool,
    num_nodes: int,
) -> np.ndarray:
    """[num_nodes, num_orbits] float64 counts (already |Aut|-normalized)."""
    native = _native_engine()
    if native is not None:
        return native.vertex_counts(edge_index, pattern, induced, num_nodes)

    counts = np.zeros((num_nodes, pattern.num_orbits), dtype=np.float64)
    membership = pattern.orbit_membership
    for mapping in _enumerate(pattern, edge_index, num_nodes, induced):
        for i, node in enumerate(mapping):
            counts[node, membership[i]] += 1
    counts /= pattern.aut_count
    return counts


def subgraph_isomorphism_edge_counts(
    edge_index: np.ndarray,
    pattern: PatternInfo,
    induced: bool,
    num_nodes: int | None = None,
) -> np.ndarray:
    """[num_edges, num_edge_orbits] float64 counts (|Aut|-normalized).

    ``edge_index`` is [2, E] with both directions present; the row index
    of the output matches the input edge order.
    """
    if pattern.edge_orbit_membership is None:
        raise ValueError("pattern lacks edge orbits; use "
                         "induced_edge_automorphism_orbits")
    if num_nodes is None:
        num_nodes = int(edge_index.max()) + 1 if edge_index.size else 0

    native = _native_engine()
    if native is not None and num_nodes <= 4096:
        return native.edge_counts(edge_index, pattern, induced, num_nodes)

    edges = edge_index.T.tolist()
    edge_dict = {(int(u), int(v)): i for i, (u, v) in enumerate(edges)}

    counts = np.zeros((len(edges), pattern.num_edge_orbits), dtype=np.float64)
    p_edges = pattern.directed_edges
    membership = pattern.edge_orbit_membership
    for mapping in _enumerate(pattern, edge_index, num_nodes, induced):
        for i, (u, v) in enumerate(p_edges):
            counts[edge_dict[(mapping[u], mapping[v])], membership[i]] += 1
    counts /= pattern.aut_count
    return counts


def count_identifiers(
    edge_index: np.ndarray,
    patterns: Sequence[PatternInfo],
    induced: bool,
    num_nodes: int,
    scope: str,
) -> np.ndarray:
    """Concatenate counts over all patterns along columns and truncate to
    int64, matching the ``.long()`` cast at reference ``utils_ids.py:27``."""
    fn = (subgraph_isomorphism_vertex_counts if scope == "global"
          else subgraph_isomorphism_edge_counts)
    cols = [fn(edge_index, p, induced, num_nodes) for p in patterns]
    return np.concatenate(cols, axis=1).astype(np.int64)


def _native_engine():
    """Return the C++ counting engine module if it has been built."""
    try:
        from gsn_tpu_torch.native import engine  # noqa: PLC0415
        return engine if engine.available() else None
    except Exception:
        return None
