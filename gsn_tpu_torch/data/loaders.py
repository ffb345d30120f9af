"""Raw dataset loaders (TU text, ZINC pickles, OGB, .g6 files).

Numpy re-implementations of reference ``utils_data_prep.py`` (a copy of
``gsn_tpu/data/loaders.py``).  Every
loader returns a list of graph dicts with keys ``x`` (node features),
``edge_index`` ([2, E] both directions), optional ``edge_features``, and
``y``, plus dataset metadata.
"""

from __future__ import annotations

import csv
import os
import pickle
from typing import Dict, List, Tuple

import numpy as np

from gsn_tpu_torch.graphs.patterns import read_graph6_file


def load_tu_data(path: str, name: str,
                 degree_as_tag: bool = False) -> Tuple[List[Dict], int]:
    """TU text format (powerful-gnns layout), reference
    utils_data_prep.py:35-136.

    Node tags are remapped to contiguous ids in first-appearance order and
    one-hot encoded over the union tag set (set-iteration order in the
    reference equals sorted ints in CPython for small ints; we sort to be
    deterministic).
    """
    graphs_raw = []
    label_dict: Dict[int, int] = {}
    feat_dict: Dict[int, int] = {}

    with open(os.path.join(path, f"{name}.txt")) as f:
        n_g = int(f.readline().strip())
        for _ in range(n_g):
            n, label = map(int, f.readline().strip().split())
            if label not in label_dict:
                label_dict[label] = len(label_dict)
            edges = []
            node_tags = []
            for j in range(n):
                row = f.readline().strip().split()
                tmp = int(row[1]) + 2
                ints = [int(w) for w in row[:tmp]]
                if ints[0] not in feat_dict:
                    feat_dict[ints[0]] = len(feat_dict)
                node_tags.append(feat_dict[ints[0]])
                for k in ints[2:]:
                    edges.append((j, k))
            graphs_raw.append((n, edges, node_tags, label_dict[label]))

    if degree_as_tag:
        remapped = []
        for n, edges, _tags, label in graphs_raw:
            deg = [0] * n
            seen = set()
            for u, v in edges:
                key = (min(u, v), max(u, v))
                if key not in seen:
                    seen.add(key)
                    deg[u] += 1
                    deg[v] += 1
            remapped.append((n, edges, deg, label))
        graphs_raw = remapped

    tagset = sorted({t for _, _, tags, _ in graphs_raw for t in tags})
    tag2index = {t: i for i, t in enumerate(tagset)}

    graphs = []
    for n, edges, tags, label in graphs_raw:
        x = np.zeros((n, len(tagset)), dtype=np.float32)
        x[range(n), [tag2index[t] for t in tags]] = 1.0
        und = {(min(u, v), max(u, v)) for u, v in edges if u != v}
        both = [(u, v) for u, v in und] + [(v, u) for u, v in und]
        ei = (np.array(both, dtype=np.int64).T if both
              else np.zeros((2, 0), np.int64))
        graphs.append({"x": x, "edge_index": ei,
                       "y": np.int64(label)})
    return graphs, len(label_dict)


def load_zinc_data(path: str, num_atom_type: int = 28,
                   num_bond_type: int = 4):
    """ZINC subset: pickled molecules + bundled split index files
    (reference utils_data_prep.py:139-174).  Requires
    ``<path>/molecules/{train,val,test}.pickle`` to exist (the reference
    repo expects a downloaded molecules.zip)."""
    graphs = []
    for split in ["train", "val", "test"]:
        with open(os.path.join(path, "molecules", f"{split}.pickle"),
                  "rb") as f:
            split_data = pickle.load(f)
        with open(os.path.join(path, "indices", f"{split}.index")) as f:
            idx = [list(map(int, row)) for row in csv.reader(f)]
        split_data = [split_data[i] for i in idx[0]]
        for mol in split_data:
            x = np.asarray(mol["atom_type"], dtype=np.int64).reshape(-1, 1)
            adj = np.asarray(mol["bond_type"])
            src, dst = np.nonzero(adj)
            ei = np.stack([src, dst]).astype(np.int64)
            ef = adj[src, dst].astype(np.int64).reshape(-1, 1)
            y = np.float32(mol["logP_SA_cycle_normalized"])
            graphs.append({"x": x, "edge_index": ei, "edge_features": ef,
                           "y": y})
    return graphs, 1, num_atom_type, num_bond_type


def load_ogb_data(path: str, name: str):
    """OGB graph-prop datasets from the standard on-disk csv layout.

    Reads ``raw/`` csv.gz files of a downloaded
    ``ogbg_*`` dataset directly (edge.csv.gz, edge-feat, node-feat,
    num-node-list, num-edge-list, graph-label), avoiding the ogb package.
    ogbg-ppa has no node features (the reference's add_zeros transform,
    utils_data_prep.py:181-185, substitutes zeros) and integer class
    labels.
    """
    import gzip

    ds_dir = os.path.join(path, name.replace("-", "_"))
    raw = os.path.join(ds_dir, "raw")
    if not os.path.isdir(raw):
        raise FileNotFoundError(
            f"OGB dataset not found at {raw}; download is required "
            "(no network egress in this environment)")

    def read_csv_gz(fname, dtype):
        with gzip.open(os.path.join(raw, fname), "rt") as f:
            return np.array([[dtype(v) for v in line.strip().split(",")]
                             for line in f if line.strip()])

    is_ppa = name == "ogbg-ppa"
    edges = read_csv_gz("edge.csv.gz", int)
    edge_feat = read_csv_gz("edge-feat.csv.gz",
                            float if is_ppa else int)
    num_nodes = read_csv_gz("num-node-list.csv.gz", int).ravel()
    num_edges = read_csv_gz("num-edge-list.csv.gz", int).ravel()
    labels = read_csv_gz("graph-label.csv.gz", float)
    if is_ppa:
        node_feat = np.zeros((int(num_nodes.sum()), 1), np.int64)
    else:
        node_feat = read_csv_gz("node-feat.csv.gz", int)

    graphs = []
    n_off = e_off = 0
    for gi in range(len(num_nodes)):
        n, e = num_nodes[gi], num_edges[gi]
        ei_half = edges[e_off:e_off + e].T
        ef_half = edge_feat[e_off:e_off + e]
        # ogb stores each undirected edge once; expand to both directions
        ei = np.concatenate([ei_half, ei_half[::-1]], axis=1)
        ef = np.concatenate([ef_half, ef_half], axis=0)
        graphs.append({
            "x": node_feat[n_off:n_off + n].astype(np.int64),
            "edge_index": ei.astype(np.int64),
            "edge_features": (ef.astype(np.float32) if is_ppa
                              else ef.astype(np.int64)),
            "y": (np.int64(labels[gi][0]) if is_ppa
                  else labels[gi].astype(np.float32)),
        })
        n_off += n
        e_off += e
    # ppa: classes; mol*: tasks (reference utils_data_prep.py:193)
    num_tasks = (int(labels.max()) + 1 if is_ppa else labels.shape[1])
    return graphs, num_tasks


def load_g6_graphs(path: str, name: str):
    """SR graph families: node features = ones, label = index (reference
    utils_data_prep.py:197-212)."""
    gs = read_graph6_file(os.path.join(path, name + ".g6"))
    graphs = []
    for i, (n, edges) in enumerate(gs):
        und = {(min(u, v), max(u, v)) for u, v in edges}
        both = sorted([(u, v) for u, v in und] + [(v, u) for u, v in und])
        graphs.append({
            "x": np.ones((n, 1), dtype=np.float32),
            "edge_index": np.array(both, dtype=np.int64).T,
            "y": np.int64(i),
        })
    return graphs, len(gs)
