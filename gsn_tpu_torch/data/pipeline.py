"""Dataset preparation: count substructures and attach identifiers.

A copy of ``gsn_tpu/data/pipeline.py``'s counting path (the raw-data
loaders and the on-disk cache stay with the reference package until a
later slice ports the CLIs):
- per-pattern orbit info is computed once, then every graph gets
  per-node/per-edge orbit count ``identifiers`` (|Aut|-normalized then
  truncated to int, reference ``utils_ids.py:27``);
- degrees come from ``edge_index[0]`` occurrence counts
  (``utils_data_gen.py:94``);
- counting runs in the native C++ engine when it builds, else in the
  Python oracle, optionally fanned out over processes.
"""

from __future__ import annotations

import concurrent.futures as cf
from typing import Dict, List, Sequence

import numpy as np

from gsn_tpu_torch.counting import (automorphism_orbits, count_identifiers,
                                    induced_edge_automorphism_orbits,
                                    line_graph_edge_automorphism_orbits)


def compute_degrees(edge_index: np.ndarray, num_nodes: int) -> np.ndarray:
    """Occurrence count of each node in edge_index[0] (reference
    utils_data_gen.py:94 uses degree(edge_index[0]))."""
    deg = np.zeros(num_nodes, dtype=np.float32)
    if edge_index.size:
        np.add.at(deg, edge_index[0], 1.0)
    return deg


def remove_self_loops(g: Dict) -> Dict:
    ei = g["edge_index"]
    keep = ei[0] != ei[1]
    if not keep.all():
        g = dict(g)
        g["edge_index"] = ei[:, keep]
        if g.get("edge_features") is not None and "edge_features" in g:
            g["edge_features"] = g["edge_features"][keep]
    return g


def build_pattern_infos(edge_lists: Sequence, id_scope: str,
                        directed_orbits: bool = False,
                        edge_automorphism: str = "induced",
                        directed: bool = False):
    """Orbit info per pattern (reference utils_data_gen.py:31-42 +
    utils.py:40-45 automorphism_fn selection)."""
    infos = []
    for el in edge_lists:
        if id_scope == "local":
            if edge_automorphism == "line_graph":
                infos.append(line_graph_edge_automorphism_orbits(el))
            else:
                infos.append(induced_edge_automorphism_orbits(
                    el, directed=directed,
                    directed_orbits=directed_orbits))
        else:
            infos.append(automorphism_orbits(el, directed=directed))
    return infos


def _prepare_one(g: Dict, patterns, induced: bool, id_scope: str) -> Dict:
    g = remove_self_loops(dict(g))
    n = g["x"].shape[0]
    g["degrees"] = compute_degrees(g["edge_index"], n)
    g["graph_size"] = n
    if g["edge_index"].shape[1] == 0 and id_scope == "local":
        total = sum(p.num_edge_orbits for p in patterns)
        g["identifiers"] = np.zeros((0, total), dtype=np.int64)
    else:
        g["identifiers"] = count_identifiers(
            g["edge_index"], patterns, induced, n,
            "local" if id_scope == "local" else "global")
    g["ids_on_edges"] = id_scope == "local"
    return g


def _prepare_batch_native(graphs, patterns, induced, id_scope,
                          num_threads):
    """One native batch call per pattern (OpenMP fan-out over graphs in
    C++) instead of one VF2 call per (graph, pattern) — amortizes ctypes
    overhead and avoids forking a multithreaded JAX process."""
    from gsn_tpu_torch.native import engine

    graphs = [remove_self_loops(dict(g)) for g in graphs]
    for g in graphs:
        n = g["x"].shape[0]
        g["degrees"] = compute_degrees(g["edge_index"], n)
        g["graph_size"] = n
        g["ids_on_edges"] = id_scope == "local"
    edge_indices = [g["edge_index"] for g in graphs]
    nodes = [g["x"].shape[0] for g in graphs]
    fn = (engine.edge_counts_batch if id_scope == "local"
          else engine.vertex_counts_batch)
    per_pattern = [fn(edge_indices, nodes, p, induced,
                      num_threads=num_threads) for p in patterns]
    for gi, g in enumerate(graphs):
        g["identifiers"] = np.concatenate(
            [cols[gi] for cols in per_pattern], axis=1).astype(np.int64)
    return graphs


def _native_batch_ok(graphs, patterns, id_scope) -> bool:
    try:
        from gsn_tpu_torch.native import engine
    except Exception:
        return False
    if not engine.available():
        return False
    if id_scope == "local" and any(
            g["x"].shape[0] > engine.MAX_DENSE_LOOKUP_NODES
            for g in graphs):
        return False
    return True


def generate_dataset(
    graphs: List[Dict],
    pattern_edge_lists: Sequence,
    id_scope: str = "global",
    induced: bool = False,
    directed_orbits: bool = False,
    num_processes: int = 1,
    edge_automorphism: str = "induced",
    directed: bool = False,
) -> tuple:
    """Attach degrees + identifiers to every graph dict.

    Returns (graphs, orbit_partition_sizes)."""
    patterns = build_pattern_infos(pattern_edge_lists, id_scope,
                                   directed_orbits, edge_automorphism,
                                   directed)
    sizes = [p.num_edge_orbits if id_scope == "local" else p.num_orbits
             for p in patterns]
    if _native_batch_ok(graphs, patterns, id_scope):
        graphs = _prepare_batch_native(graphs, patterns, induced,
                                       id_scope, num_processes)
    elif num_processes > 1:
        import functools
        fn = functools.partial(_prepare_one, patterns=patterns,
                               induced=induced, id_scope=id_scope)
        with cf.ProcessPoolExecutor(max_workers=num_processes) as ex:
            graphs = list(ex.map(fn, graphs, chunksize=16))
    else:
        graphs = [_prepare_one(g, patterns, induced, id_scope)
                  for g in graphs]
    return graphs, sizes
