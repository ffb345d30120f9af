"""Subgraph-isomorphism enumeration (VF2-style) over undirected graphs.

This is the correctness oracle for the structural-identifier pipeline: it
enumerates *all* injective mappings of a pattern H into a host graph G,
either as monomorphisms (``induced=False`` — every pattern edge maps to a
host edge) or induced isomorphisms (``induced=True`` — pattern non-edges
must map to host non-edges).  Semantics match graph-tool's
``subgraph_isomorphism(H, G, induced=..., subgraph=True)`` as used by the
reference at ``utils_graph_processing.py:22,116,156``.

Host adjacency is held as Python int bitsets, which makes candidate
filtering and induced checks O(n/64) word ops.  A C++ engine
(`gsn_tpu_torch.native`) provides the same API for the production preprocessing
path; this module stays as the slow-but-obviously-correct reference.
"""

from __future__ import annotations

from typing import Iterable, Iterator, List, Sequence, Tuple


def build_adjacency(n: int, edges: Iterable[Tuple[int, int]]) -> List[int]:
    """Bitset adjacency (no self-loops, parallel edges collapse)."""
    adj = [0] * n
    for u, v in edges:
        if u == v:
            continue
        adj[u] |= 1 << v
        adj[v] |= 1 << u
    return adj


def _pattern_order(p_adj: Sequence[int], np_: int) -> List[int]:
    """Search order over pattern vertices: greedy max-connectivity-first
    (classic VF2 candidate ordering: prefer vertices adjacent to already
    ordered ones, tie-break on degree)."""
    if np_ == 0:
        return []
    degs = [bin(a).count("1") for a in p_adj]
    order = [max(range(np_), key=lambda v: degs[v])]
    in_order = 1 << order[0]
    while len(order) < np_:
        best, best_key = None, None
        for v in range(np_):
            if (in_order >> v) & 1:
                continue
            conn = bin(p_adj[v] & in_order).count("1")
            key = (conn, degs[v])
            if best is None or key > best_key:
                best, best_key = v, key
        order.append(best)
        in_order |= 1 << best
    return order


def enumerate_subgraph_isomorphisms(
    pattern_adj: Sequence[int],
    num_pattern: int,
    host_adj: Sequence[int],
    num_host: int,
    induced: bool,
) -> Iterator[List[int]]:
    """Yield mappings as lists ``m`` with ``m[pattern_vertex] = host_vertex``.

    All injective mappings are enumerated (one per automorphic placement),
    matching graph-tool's generator mode.
    """
    if num_pattern > num_host:
        return
    order = _pattern_order(pattern_adj, num_pattern)
    p_deg = [bin(a).count("1") for a in pattern_adj]
    h_deg = [bin(a).count("1") for a in host_adj]

    # For each position in the order: bitmask of previously-placed pattern
    # neighbors and (for induced) previously-placed pattern non-neighbors.
    nbr_prev: List[List[int]] = []   # indices into `order` of placed neighbors
    non_prev: List[List[int]] = []
    for idx, v in enumerate(order):
        nbrs, nons = [], []
        for jdx in range(idx):
            u = order[jdx]
            if (pattern_adj[v] >> u) & 1:
                nbrs.append(jdx)
            else:
                nons.append(jdx)
        nbr_prev.append(nbrs)
        non_prev.append(nons)

    mapping = [0] * num_pattern  # order-position -> host vertex
    full_host = (1 << num_host) - 1
    out = [0] * num_pattern

    def candidates(idx: int, used: int) -> int:
        cand = full_host
        for jdx in nbr_prev[idx]:
            cand &= host_adj[mapping[jdx]]
        cand &= ~used
        if induced:
            for jdx in non_prev[idx]:
                cand &= ~host_adj[mapping[jdx]]
        return cand

    def dfs(idx: int, used: int) -> Iterator[List[int]]:
        v = order[idx]
        need = p_deg[v]
        cand = candidates(idx, used)
        while cand:
            h_bit = cand & -cand
            cand ^= h_bit
            h = h_bit.bit_length() - 1
            if h_deg[h] < need:
                continue
            mapping[idx] = h
            if idx + 1 == num_pattern:
                for jdx in range(num_pattern):
                    out[order[jdx]] = mapping[jdx]
                yield list(out)
            else:
                yield from dfs(idx + 1, used | h_bit)

    yield from dfs(0, 0)


def count_automorphisms(adj: Sequence[int], n: int) -> int:
    """|Aut(H)| via monomorphism enumeration H -> H (equal vertex/edge
    counts make every monomorphism an automorphism)."""
    return sum(1 for _ in enumerate_subgraph_isomorphisms(adj, n, adj, n, False))


# ---------------------------------------------------------------------------
# directed variant (reference --directed flag; gt directed VF2)
# ---------------------------------------------------------------------------

def build_directed_adjacency(n, edges):
    """(out_adj, in_adj) bitsets; self-loops skipped, parallels collapse."""
    out_adj = [0] * n
    in_adj = [0] * n
    for u, v in edges:
        if u == v:
            continue
        out_adj[u] |= 1 << v
        in_adj[v] |= 1 << u
    return out_adj, in_adj


def enumerate_directed_subgraph_isomorphisms(
    p_out: Sequence[int], p_in: Sequence[int], num_pattern: int,
    h_out: Sequence[int], h_in: Sequence[int], num_host: int,
    induced: bool,
) -> Iterator[List[int]]:
    """Directed monomorphisms / induced isomorphisms: pattern edge u->v
    must map to a host edge m(u)->m(v); induced additionally forbids
    host edges between images of pattern non-edges (per direction)."""
    if num_pattern > num_host:
        return
    union_adj = [p_out[v] | p_in[v] for v in range(num_pattern)]
    order = _pattern_order(union_adj, num_pattern)
    p_deg_out = [bin(a).count("1") for a in p_out]
    p_deg_in = [bin(a).count("1") for a in p_in]
    h_deg_out = [bin(a).count("1") for a in h_out]
    h_deg_in = [bin(a).count("1") for a in h_in]

    # per order position: earlier positions that are out/in neighbors or
    # (for induced) non-neighbors in each direction
    succ_prev, pred_prev, non_succ_prev, non_pred_prev = [], [], [], []
    for idx, v in enumerate(order):
        sp, pp, nsp, npp = [], [], [], []
        for jdx in range(idx):
            u = order[jdx]
            if (p_out[u] >> v) & 1:
                pp.append(jdx)       # u -> v: m(v) in out(m(u))
            elif induced:
                npp.append(jdx)
            if (p_out[v] >> u) & 1:
                sp.append(jdx)       # v -> u: m(v) in in(m(u))
            elif induced:
                nsp.append(jdx)
        succ_prev.append(sp)
        pred_prev.append(pp)
        non_succ_prev.append(nsp)
        non_pred_prev.append(npp)

    mapping = [0] * num_pattern
    out = [0] * num_pattern
    full_host = (1 << num_host) - 1

    def dfs(idx: int, used: int) -> Iterator[List[int]]:
        v = order[idx]
        cand = full_host & ~used
        for jdx in pred_prev[idx]:
            cand &= h_out[mapping[jdx]]
        for jdx in succ_prev[idx]:
            cand &= h_in[mapping[jdx]]
        if induced:
            for jdx in non_pred_prev[idx]:
                cand &= ~h_out[mapping[jdx]]
            for jdx in non_succ_prev[idx]:
                cand &= ~h_in[mapping[jdx]]
        no, ni = p_deg_out[v], p_deg_in[v]
        while cand:
            h_bit = cand & -cand
            cand ^= h_bit
            h = h_bit.bit_length() - 1
            if h_deg_out[h] < no or h_deg_in[h] < ni:
                continue
            mapping[idx] = h
            if idx + 1 == num_pattern:
                for jdx in range(num_pattern):
                    out[order[jdx]] = mapping[jdx]
                yield list(out)
            else:
                yield from dfs(idx + 1, used | h_bit)

    yield from dfs(0, 0)
