"""Substructure (pattern) vocabulary: generators + graph6 codec (a copy
of ``gsn_tpu/graphs/patterns.py``).

GSN needs a vocabulary of small pattern graphs whose
subgraph-isomorphism orbit counts become structural identifiers.  The
reference builds these with networkx generators and ``nx.read_graph6``
(see reference ``utils.py:16-33``).  We implement the generators and the
graph6 codec from scratch (no networkx) so the preprocessing pipeline has
zero third-party graph dependencies.

A pattern is represented as a plain ``list[tuple[int, int]]`` of
undirected edges over vertices ``0..n-1``.
"""

from __future__ import annotations

import itertools
import os
from typing import Iterable, List, Sequence, Tuple

Edge = Tuple[int, int]
EdgeList = List[Edge]


# ---------------------------------------------------------------------------
# Generators (semantics match the networkx generators used by the reference)
# ---------------------------------------------------------------------------

def cycle_graph(k: int) -> EdgeList:
    """Cycle on k vertices (k >= 3)."""
    if k < 3:
        raise ValueError("cycle_graph requires k >= 3")
    return [(i, (i + 1) % k) for i in range(k)]


def path_graph(k: int) -> EdgeList:
    """Path on k vertices."""
    return [(i, i + 1) for i in range(k - 1)]


def complete_graph(k: int) -> EdgeList:
    """Complete graph on k vertices."""
    return [(i, j) for i in range(k) for j in range(i + 1, k)]


def star_graph(k: int) -> EdgeList:
    """Star with k leaves (k+1 vertices), center 0 — matches nx.star_graph."""
    return [(0, i) for i in range(1, k + 1)]


def binomial_tree(k: int) -> EdgeList:
    """Binomial tree of order k (2**k vertices) — matches nx.binomial_tree."""
    edges: EdgeList = []
    n = 1
    for _ in range(k):
        edges = edges + [(u + n, v + n) for (u, v) in edges] + [(0, n)]
        n *= 2
    return edges


def diamond_graph(_k: int | None = None) -> EdgeList:
    """K4 minus an edge — matches nx.diamond_graph."""
    return [(0, 1), (0, 2), (1, 2), (1, 3), (2, 3)]


def nonisomorphic_trees(k: int) -> List[EdgeList]:
    """All non-isomorphic free trees on k vertices.

    Enumerated via Pruefer sequences and de-duplicated with an AHU
    canonical form rooted at the tree centroid(s).  Exponential in k but
    fine for the k <= 10 range patterns live in.
    """
    if k <= 1:
        return [[]]
    if k == 2:
        return [[(0, 1)]]

    seen = {}
    for seq in itertools.product(range(k), repeat=k - 2):
        edges = _pruefer_to_edges(list(seq), k)
        key = _tree_canonical_form(edges, k)
        if key not in seen:
            seen[key] = edges
    return list(seen.values())


def _pruefer_to_edges(seq: List[int], n: int) -> EdgeList:
    degree = [1] * n
    for v in seq:
        degree[v] += 1
    edges: EdgeList = []
    import heapq

    leaves = [v for v in range(n) if degree[v] == 1]
    heapq.heapify(leaves)
    for v in seq:
        leaf = heapq.heappop(leaves)
        edges.append((leaf, v))
        degree[v] -= 1
        if degree[v] == 1:
            heapq.heappush(leaves, v)
    u, w = heapq.heappop(leaves), heapq.heappop(leaves)
    edges.append((u, w))
    return edges


def _tree_canonical_form(edges: EdgeList, n: int) -> str:
    """AHU canonical string of a free tree, rooted at its centroid."""
    adj = [[] for _ in range(n)]
    for u, v in edges:
        adj[u].append(v)
        adj[v].append(u)

    # find centroid(s) by repeatedly stripping leaves
    deg = [len(a) for a in adj]
    count = n
    layer = [v for v in range(n) if deg[v] <= 1]
    removed = [False] * n
    while count > 2:
        nxt = []
        for v in layer:
            removed[v] = True
            count -= 1
            for u in adj[v]:
                if not removed[u]:
                    deg[u] -= 1
                    if deg[u] == 1:
                        nxt.append(u)
        layer = nxt

    centroids = [v for v in range(n) if not removed[v]]

    def ahu(root: int) -> str:
        # iterative post-order AHU encoding
        enc = {}
        stack = [(root, -1, False)]
        while stack:
            v, parent, processed = stack.pop()
            if processed:
                children = sorted(enc[c] for c in adj[v] if c != parent)
                enc[v] = "(" + "".join(children) + ")"
            else:
                stack.append((v, parent, True))
                for c in adj[v]:
                    if c != parent:
                        stack.append((c, v, False))
        return enc[root]

    return min(ahu(c) for c in centroids)


# ---------------------------------------------------------------------------
# graph6 codec (format spec: https://users.cecs.anu.edu.au/~bdm/data/formats.txt)
# ---------------------------------------------------------------------------

def parse_graph6(line: str | bytes) -> Tuple[int, EdgeList]:
    """Decode one graph6 string -> (num_vertices, edge_list)."""
    if isinstance(line, bytes):
        line = line.decode("ascii")
    line = line.strip()
    if line.startswith(">>graph6<<"):
        line = line[10:]
    data = [ord(c) - 63 for c in line]
    if any(b < 0 or b > 63 for b in data):
        raise ValueError("invalid graph6 character")

    if data[0] <= 62:
        n = data[0]
        bits_data = data[1:]
    elif data[1] <= 62:
        n = (data[1] << 12) | (data[2] << 6) | data[3]
        bits_data = data[4:]
    else:
        n = (
            (data[2] << 30)
            | (data[3] << 24)
            | (data[4] << 18)
            | (data[5] << 12)
            | (data[6] << 6)
            | data[7]
        )
        bits_data = data[8:]

    edges: EdgeList = []
    bit_idx = 0
    for j in range(1, n):
        for i in range(j):
            byte = bits_data[bit_idx // 6]
            bit = (byte >> (5 - bit_idx % 6)) & 1
            if bit:
                edges.append((i, j))
            bit_idx += 1
    return n, edges


def write_graph6(n: int, edges: Iterable[Edge]) -> str:
    """Encode (n, edge_list) -> graph6 string (n < 63 path only)."""
    adj = set()
    for u, v in edges:
        if u != v:
            adj.add((min(u, v), max(u, v)))
    bits = []
    for j in range(1, n):
        for i in range(j):
            bits.append(1 if (i, j) in adj else 0)
    while len(bits) % 6:
        bits.append(0)
    chars = [chr(n + 63)]
    for b in range(0, len(bits), 6):
        val = 0
        for bit in bits[b : b + 6]:
            val = (val << 1) | bit
        chars.append(chr(val + 63))
    return "".join(chars)


def read_graph6_file(path: str) -> List[Tuple[int, EdgeList]]:
    """Read a .g6 file (one graph per line)."""
    graphs = []
    with open(path, "rb") as f:
        for raw in f:
            raw = raw.strip()
            if raw:
                graphs.append(parse_graph6(raw))
    return graphs


# ---------------------------------------------------------------------------
# Vocabulary assembly (mirrors reference utils.py:16-33 get_custom_edge_list
# and utils.py:53-92 id_type dispatch)
# ---------------------------------------------------------------------------

_GENERATORS = {
    "cycle_graph": cycle_graph,
    "path_graph": path_graph,
    "complete_graph": complete_graph,
    "star_graph": star_graph,
    "binomial_tree": binomial_tree,
    "nonisomorphic_trees": nonisomorphic_trees,
    "diamond_graph": diamond_graph,
}


def get_custom_edge_list(
    ks: Sequence[int],
    substructure_type: str | None = None,
    filename: str | None = None,
) -> List[EdgeList]:
    """List of pattern edge lists for sizes ``ks``.

    Either from a named generator family or from ``graph{k}c.g6`` files in
    directory ``filename`` (all connected simple graphs of size k).
    Mirrors reference ``utils.py:16-33``.
    """
    if substructure_type is None and filename is None:
        raise ValueError("specify a substructure type or a .g6 directory")
    edge_lists: List[EdgeList] = []
    for k in ks:
        if substructure_type is not None:
            out = _GENERATORS[substructure_type](k)
        else:
            out = [e for _, e in read_graph6_file(
                os.path.join(filename, f"graph{k}c.g6"))]
        if isinstance(out, list) and (len(out) == 0 or isinstance(out[0], list)):
            edge_lists += out  # generator returned a list of graphs
        else:
            edge_lists.append(out)
    return edge_lists


def resolve_pattern_vocabulary(
    id_type: str,
    k: Sequence[int] | int,
    root_folder: str | None = None,
    custom_edge_list: List[EdgeList] | None = None,
) -> List[EdgeList]:
    """Resolve an ``id_type`` + ``k`` spec into a list of pattern edge lists.

    Mirrors reference ``utils.py:53-92`` (process_arguments), including the
    k_min conventions (star_graph: 2, everything else: 3).
    """
    ks = [k] if isinstance(k, int) else list(k)
    families = [
        "cycle_graph", "path_graph", "complete_graph",
        "binomial_tree", "star_graph", "nonisomorphic_trees",
    ]
    if id_type in families:
        k_max = ks[0]
        k_min = 2 if id_type == "star_graph" else 3
        return get_custom_edge_list(list(range(k_min, k_max + 1)), id_type)
    if id_type.endswith("_chosen_k") and id_type[: -len("_chosen_k")] in families:
        return get_custom_edge_list(ks, id_type[: -len("_chosen_k")])
    if id_type == "all_simple_graphs":
        k_max = ks[0]
        return get_custom_edge_list(
            list(range(3, k_max + 1)),
            filename=os.path.join(root_folder, "all_simple_graphs"),
        )
    if id_type == "all_simple_graphs_chosen_k":
        return get_custom_edge_list(
            ks, filename=os.path.join(root_folder, "all_simple_graphs"))
    if id_type == "diamond_graph":
        return [diamond_graph()]
    if id_type == "custom":
        if custom_edge_list is None:
            raise ValueError("custom id_type requires custom_edge_list")
        return custom_edge_list
    raise NotImplementedError(f"id_type {id_type!r} is not supported")
