"""Automorphism-orbit computation for pattern graphs.

Matches the reference semantics exactly:
- vertex orbits: min-label union over all automorphisms, then made
  contiguous with a sorted-unique relabel (reference
  ``utils_graph_processing.py:10-56``);
- induced edge orbits: pairs/frozensets of endpoint vertex orbits,
  indexed in first-occurrence order over the *sorted undirected* edge
  list (reference ``utils_graph_processing.py:58-100``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .vf2 import (build_adjacency, build_directed_adjacency,
                  enumerate_directed_subgraph_isomorphisms,
                  enumerate_subgraph_isomorphisms)


@dataclasses.dataclass
class PatternInfo:
    """Everything the counting stage needs to know about one pattern."""

    num_vertices: int
    edges: List[Tuple[int, int]]          # canonical undirected, deduped
    adj: List[int]                        # bitset adjacency
    aut_count: int
    # vertex scope
    orbit_membership: List[int]           # vertex -> contiguous orbit id
    orbit_partition: Dict[int, List[int]]  # orbit id -> vertices
    # edge scope (None unless computed)
    directed_edges: List[Tuple[int, int]] | None = None  # sorted both-dirs list
    edge_orbit_membership: List[int] | None = None       # index into directed_edges
    edge_orbit_partition: Dict[int, List[Tuple[int, int]]] | None = None
    # directed-pattern support (reference --directed)
    directed: bool = False
    out_adj: List[int] | None = None
    in_adj: List[int] | None = None

    @property
    def num_orbits(self) -> int:
        return len(self.orbit_partition)

    @property
    def num_edge_orbits(self) -> int:
        return len(self.edge_orbit_partition)


def _canonical_edges(edge_list: Sequence[Tuple[int, int]]):
    """Dedup/undirect an edge list; vertex count = max index + 1."""
    n = 0
    eset = set()
    for u, v in edge_list:
        n = max(n, u + 1, v + 1)
        if u != v:
            eset.add((min(u, v), max(u, v)))
    return n, sorted(eset)


def automorphism_orbits(edge_list: Sequence[Tuple[int, int]],
                        directed: bool = False,
                        **_kw) -> PatternInfo:
    """Vertex automorphism orbits of a pattern.

    Reference parity (``utils_graph_processing.py:10-56``): each vertex's
    orbit label is the min over one sweep per automorphism of
    ``min(original_index, current_label_of_image)``, applied in
    enumeration order, then compacted with np.unique.  We replicate the
    same sweep (it converges to true orbits because the full automorphism
    group is enumerated).
    """
    if directed:
        n = 0
        eset = set()
        for u, v in edge_list:
            n = max(n, u + 1, v + 1)
            if u != v:
                eset.add((u, v))
        edges = sorted(eset)
        adj = build_adjacency(n, edges)      # union adjacency
        out_adj, in_adj = build_directed_adjacency(n, edges)
        auts = list(enumerate_directed_subgraph_isomorphisms(
            out_adj, in_adj, n, out_adj, in_adj, n, False))
    else:
        n, edges = _canonical_edges(edge_list)
        adj = build_adjacency(n, edges)
        out_adj = in_adj = None
        auts = list(enumerate_subgraph_isomorphisms(adj, n, adj, n, False))
    label = list(range(n))
    for aut in auts:
        for original, image in enumerate(aut):
            label[image] = min(original, label[image])
    _, contiguous = np.unique(label, return_inverse=True)
    orbit_membership = [int(o) for o in contiguous]

    orbit_partition: Dict[int, List[int]] = {}
    for v, o in enumerate(orbit_membership):
        orbit_partition.setdefault(o, []).append(v)

    return PatternInfo(
        num_vertices=n,
        edges=edges,
        adj=adj,
        aut_count=len(auts),
        orbit_membership=orbit_membership,
        orbit_partition=orbit_partition,
        directed=directed,
        out_adj=out_adj,
        in_adj=in_adj,
    )


def induced_edge_automorphism_orbits(edge_list: Sequence[Tuple[int, int]],
                                     directed: bool = False,
                                     directed_orbits: bool = False,
                                     **_kw) -> PatternInfo:
    """Edge orbits induced by the vertex automorphism group.

    The directed (both-directions) edge list is sorted lexicographically
    (matching PyG ``to_undirected`` coalescing at
    ``utils_graph_processing.py:74``); edge-orbit ids are assigned in
    first-occurrence order over that list.
    """
    info = automorphism_orbits(edge_list, directed=directed)
    if directed:
        # directed patterns keep their edge list as-is (reference
        # utils_graph_processing.py:73-74 skips to_undirected)
        both = list(info.edges)
    else:
        both = sorted([(u, v) for u, v in info.edges]
                      + [(v, u) for u, v in info.edges])

    orbit2ind: Dict[object, int] = {}
    membership: List[int] = []
    partition: Dict[int, List[Tuple[int, int]]] = {}
    for (u, v) in both:
        if directed_orbits:
            key = (info.orbit_membership[u], info.orbit_membership[v])
        else:
            key = frozenset(
                (info.orbit_membership[u], info.orbit_membership[v]))
        ind = orbit2ind.setdefault(key, len(orbit2ind))
        membership.append(ind)
        partition.setdefault(ind, []).append((u, v))

    info.directed_edges = both
    info.edge_orbit_membership = membership
    info.edge_orbit_partition = partition
    return info


def line_graph_edge_automorphism_orbits(edge_list: Sequence[Tuple[int, int]],
                                        directed: bool = False,
                                        **_kw) -> PatternInfo:
    """Edge orbits via line-graph vertex automorphisms (the reference's
    deprecated ``edge_automorphism_orbits``, utils_graph_processing.py:189-251).

    Line-graph orbits can merge edge classes that the induced (vertex-
    automorphism) partition distinguishes, which is why the reference
    deprecated it.  Orbit ids are assigned over the sorted undirected
    edge list in first-occurrence order of the line-graph orbit label
    (the reference's single-direction indexing breaks for the second
    direction of each edge; we assign both directions of an undirected
    edge the same orbit, which is the only consistent reading).
    """
    info = automorphism_orbits(edge_list, directed=directed)
    edges = info.edges                      # canonical undirected, sorted
    m = len(edges)

    # line graph: vertices = edges, adjacency = shared endpoint
    lg_edges = []
    for i in range(m):
        for j in range(i + 1, m):
            if set(edges[i]) & set(edges[j]):
                lg_edges.append((i, j))
    lg_adj = build_adjacency(m, lg_edges)
    auts = list(enumerate_subgraph_isomorphisms(lg_adj, m, lg_adj, m,
                                                False))
    label = list(range(m))
    for aut in auts:
        for original, image in enumerate(aut):
            label[image] = min(original, label[image])
    _, contiguous = np.unique(label, return_inverse=True)

    both = sorted([(u, v) for u, v in edges] + [(v, u) for u, v in edges])
    undirected_of = {e: i for i, e in enumerate(edges)}
    orbit2ind: Dict[int, int] = {}
    membership: List[int] = []
    partition: Dict[int, List[Tuple[int, int]]] = {}
    for (u, v) in both:
        lg_orbit = int(contiguous[undirected_of[(min(u, v), max(u, v))]])
        ind = orbit2ind.setdefault(lg_orbit, len(orbit2ind))
        membership.append(ind)
        partition.setdefault(ind, []).append((u, v))

    info.directed_edges = both
    info.edge_orbit_membership = membership
    info.edge_orbit_partition = partition
    return info
