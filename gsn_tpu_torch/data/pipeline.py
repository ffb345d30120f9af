"""Dataset preparation: load -> count substructures -> cache -> encode.

A copy of ``gsn_tpu/data/pipeline.py`` (reference ``utils.py:197-345`` +
``utils_data_gen.py``):
- per-pattern orbit info is computed once, then every graph gets
  per-node/per-edge orbit count ``identifiers`` (|Aut|-normalized then
  truncated to int, reference ``utils_ids.py:27``);
- degrees come from ``edge_index[0]`` occurrence counts
  (``utils_data_gen.py:94``);
- counting runs in the native C++ engine when it builds, else in the
  Python oracle, optionally fanned out over processes;
- results are cached as one pickle per dataset keyed by
  ``{id_type}[_induced]_{k}`` with k-downgrade (reusing a larger-k cache
  by slicing identifier columns, ``utils.py:295-345``).  The file names
  and the pickled ``(graphs, num_classes, sizes)`` layout are the
  reference package's, so either package reads the other's cache.
"""

from __future__ import annotations

import concurrent.futures as cf
import glob
import os
import pickle
import re
from typing import Dict, List, Optional, Sequence

import numpy as np

from gsn_tpu_torch.counting import (automorphism_orbits, count_identifiers,
                                    induced_edge_automorphism_orbits,
                                    line_graph_edge_automorphism_orbits)
from gsn_tpu_torch.graphs.patterns import resolve_pattern_vocabulary
from gsn_tpu_torch.spans import span
from .loaders import load_g6_graphs, load_ogb_data, load_tu_data, load_zinc_data

SR_FAMILIES = {"sr16622", "sr251256", "sr261034", "sr281264", "sr291467",
               "sr351668", "sr351899", "sr361446", "sr401224"}


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

    Returns (graphs, orbit_partition_sizes).  Timed as the
    ``data.count`` span."""
    with span("data.count"):
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


# ---------------------------------------------------------------------------
# Cache (reference utils.py:197-345)
# ---------------------------------------------------------------------------

def _cache_name(id_type: str, induced: bool, directed_orbits: bool,
                id_scope: str, k) -> str:
    tag = id_type
    if induced:
        tag += "_induced"
    if directed_orbits and id_scope == "local":
        tag += "_directed_orbits"
    return f"{tag}_{k}.pkl"


def _save_cache(path: str, graphs, num_classes, sizes):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump((graphs, num_classes, sizes), f,
                    protocol=pickle.HIGHEST_PROTOCOL)


def _load_cache(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)


def _find_downgrade(data_folder: str, id_type: str, induced: bool,
                    directed_orbits: bool, id_scope: str, k: int):
    """Find a cache with k' >= k (reference utils.py:310-330)."""
    pattern = _cache_name(id_type, induced, directed_orbits, id_scope,
                          "[0-9]*")
    for name in glob.glob(os.path.join(data_folder, pattern)):
        k_found = int(re.findall(r"\d+", os.path.basename(name))[-1])
        if k_found >= k:
            return name, k_found
    return None, None


def downgrade_k(graphs, k: int, sizes, k_min: int):
    """Keep only orbits of patterns up to size k (reference
    utils.py:332-345)."""
    keep = sum(sizes[0:k - k_min + 1])
    out = []
    for g in graphs:
        g = dict(g)
        g["identifiers"] = g["identifiers"][:, :keep]
        out.append(g)
    return out, sizes[0:k - k_min + 1]


DOWNGRADABLE = {"cycle_graph", "path_graph", "complete_graph",
                "binomial_tree", "star_graph"}


def prepare_dataset(
    path: str,
    dataset: str,
    name: str,
    id_scope: str,
    id_type: str,
    k,
    regression: bool = False,
    induced: bool = False,
    directed_orbits: bool = False,
    custom_edge_list=None,
    root_folder: Optional[str] = None,
    num_processes: int = 1,
    use_cache: bool = True,
    cache_root: Optional[str] = None,
):
    """Full prepare path with caching (reference utils.py:197-279).

    ``cache_root`` overrides where the processed cache lives (the raw
    data location may be read-only, e.g. the mounted reference datasets).
    Returns (graphs, num_classes, orbit_partition_sizes)."""
    data_folder = os.path.join(cache_root or path, "processed", id_scope)
    k_val = k[0] if isinstance(k, (list, tuple)) else k
    cache_file = (os.path.join(
        data_folder,
        _cache_name(id_type, induced, directed_orbits, id_scope, k_val))
        if id_type != "custom" else None)

    if use_cache and cache_file and os.path.exists(cache_file):
        return _load_cache(cache_file)

    if use_cache and cache_file and id_type in DOWNGRADABLE:
        k_min = 2 if id_type == "star_graph" else 3
        found, _k_found = _find_downgrade(
            data_folder, id_type, induced, directed_orbits, id_scope, k_val)
        if found:
            graphs, num_classes, sizes = _load_cache(found)
            graphs, sizes = downgrade_k(graphs, k_val, sizes, k_min)
            _save_cache(cache_file, graphs, num_classes, sizes)
            return graphs, num_classes, sizes

    graphs, num_classes = load_raw(path, dataset, name)
    vocab = resolve_pattern_vocabulary(
        id_type, k if isinstance(k, (list, tuple)) else [k],
        root_folder=root_folder, custom_edge_list=custom_edge_list)
    graphs, sizes = generate_dataset(
        graphs, vocab, id_scope=id_scope, induced=induced,
        directed_orbits=directed_orbits, num_processes=num_processes)

    if use_cache and cache_file:
        _save_cache(cache_file, graphs, num_classes, sizes)
    return graphs, num_classes, sizes


def load_raw(path: str, dataset: str, name: str):
    """Dispatch to the right raw loader (reference utils_data_gen.py:44-56)."""
    if "ogb" in path or dataset == "ogb":
        return load_ogb_data(path, name)
    if name == "ZINC":
        graphs, num_classes, _na, _nb = load_zinc_data(path)
        return graphs, num_classes
    if name in SR_FAMILIES:
        return load_g6_graphs(path, name)
    return load_tu_data(path, name)
