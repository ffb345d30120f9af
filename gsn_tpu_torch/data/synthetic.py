"""Synthetic molecule-shaped datasets for smoke runs and benchmarks.

A copy of ``bench.py``'s generators (``_molecule_graphs``,
``make_zinc_like``, ``make_molhiv_like`` and ``make_dgn_like``), so the
port builds the benchmark's inputs without importing the JAX package:
chains of 15-34 atoms with n/4 random chords.  ZINC-like graphs have 28
atom types, 4 bond types, and cycle counts for k=3..8 as global-scope
identifiers; molhiv-like graphs have the 9 OGB atom fields, the 3 OGB
bond fields and induced edge-level (local-scope) cycle counts for
k=3..6; DGN-like graphs have the atom fields and, as their edge-level
vector field, local-scope cycle counts for k=3..6.

``write_zinc_dataset`` writes such molecules in the ZINC loader's on-disk
layout, so the CLI's whole data path (loader, counting, cache,
splits) runs on them; ``write_molhiv_dataset`` writes molhiv-like
molecules as OGB's raw csv.gz files with one train/val/test split;
``write_imdb_dataset`` writes IMDB-BINARY-like ego-networks in the TU
text layout with ten folds; ``write_sr16622`` writes the two strongly
regular graphs of SR(16,6,2,2) for the isomorphism mode.
"""

from __future__ import annotations

import gzip
import os
import pickle

import numpy as np

from .directional import assemble_directions
from .encoding import encode
from .pipeline import generate_dataset
from .splits import stratified_kfold_indices
from gsn_tpu_torch.graphs.patterns import cycle_graph, write_graph6


def _molecule_graphs(num_graphs, seed, atom_dims, bond_dims):
    rng = np.random.RandomState(seed)
    graphs = []
    for _ in range(num_graphs):
        n = int(rng.randint(15, 35))
        edges = {(i, i + 1) for i in range(n - 1)}
        for _ in range(n // 4):
            u, v = rng.randint(0, n, 2)
            if u != v:
                edges.add((min(u, v), max(u, v)))
        both = sorted([(u, v) for u, v in edges]
                      + [(v, u) for u, v in edges])
        ei = np.array(both, dtype=np.int64).T
        x = np.stack([rng.randint(0, d, n) for d in atom_dims],
                     1).astype(np.int64)
        ef = np.stack([rng.randint(0, d, ei.shape[1]) for d in bond_dims],
                      1).astype(np.int64)
        graphs.append({"x": x, "edge_index": ei, "edge_features": ef,
                       "y": np.float32(rng.rand() > 0.5)})
    return graphs


def make_zinc_like(num_graphs, seed=0):
    """(graphs, d_id): ZINC-shaped graphs with encoded cycle-count ids."""
    graphs = _molecule_graphs(num_graphs, seed, [28], [4])
    vocab = [cycle_graph(k) for k in range(3, 9)]
    graphs, _ = generate_dataset(graphs, vocab, id_scope="global",
                                 induced=False)
    graphs, _eid, d_id, _ed, _dd = encode(graphs, "one_hot_unique")
    return graphs, d_id


def make_molhiv_like(num_graphs, seed=0):
    """OGB molhiv shapes: 9-field atom / 3-field bond categoricals,
    edge-scope induced cycle counts (reference --id_scope local
    --induced True --k 6)."""
    graphs = _molecule_graphs(num_graphs, seed,
                              [119, 4, 12, 12, 10, 6, 6, 2, 2],
                              [5, 6, 2])
    vocab = [cycle_graph(k) for k in (3, 4, 5, 6)]
    graphs, _ = generate_dataset(graphs, vocab, id_scope="local",
                                 induced=True)
    graphs, _eid, d_id, _ed, _dd = encode(graphs, "one_hot_unique")
    return graphs, d_id


def make_dgn_like(num_graphs, seed=0):
    """molhiv-scale DGN inputs: 9-field atom categoricals, edge-level
    cycle-count vector field (reference directional_gsn
    molhiv_10_runs.sh: --directions subgraphs --id_type cycle_graph
    --k 6 --id_scope local)."""
    graphs = _molecule_graphs(num_graphs, seed,
                              [119, 4, 12, 12, 10, 6, 6, 2, 2],
                              [5, 6, 2])
    for g in graphs:
        g.pop("edge_features")
    vocab = [cycle_graph(k) for k in (3, 4, 5, 6)]
    graphs, _ = generate_dataset(graphs, vocab, id_scope="local",
                                 induced=False)
    return assemble_directions(graphs, directions=("subgraphs",),
                               id_scope="local")


ZINC_SPLITS = ("train", "val", "test")


def write_zinc_dataset(root, sizes=(10000, 1000, 1000), seed=0):
    """ZINC-like molecules in the ZINC loader's layout
    (``data/loaders.py::load_zinc_data``) under
    ``<root>/chemical/ZINC``: ``molecules/{train,val,test}.pickle`` (each
    molecule's ``atom_type`` [n], symmetric ``bond_type`` [n, n] with
    types 1..3 on its bonds, 0 elsewhere, and a float target),
    ``indices/{split}.index`` and the one split's
    ``10fold_idx/{train,val,test}_idx-0.txt`` over the concatenated
    train, val, test order.  ``sizes``: molecules per split (the ZINC
    subset's are the default).  Returns the dataset directory."""
    base = os.path.join(root, "chemical", "ZINC")
    for sub in ("molecules", "indices", "10fold_idx"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    rng = np.random.RandomState(seed)
    offset = 0
    for i, (split, num) in enumerate(zip(ZINC_SPLITS, sizes)):
        mols = []
        for g in _molecule_graphs(num, seed + 1 + i, [28], [3]):
            n = g["x"].shape[0]
            adj = np.zeros((n, n), np.int64)
            src, dst = g["edge_index"]
            up = src < dst
            # one bond type per undirected bond, in 1..3 (a 0 is no bond)
            adj[src[up], dst[up]] = g["edge_features"][up, 0] + 1
            adj = adj + adj.T
            mols.append({"atom_type": g["x"][:, 0],
                         "bond_type": adj,
                         "logP_SA_cycle_normalized": np.float32(
                             rng.randn())})
        with open(os.path.join(base, "molecules", f"{split}.pickle"),
                  "wb") as f:
            pickle.dump(mols, f, protocol=pickle.HIGHEST_PROTOCOL)
        with open(os.path.join(base, "indices", f"{split}.index"),
                  "w") as f:
            f.write(",".join(map(str, range(num))))
        np.savetxt(os.path.join(base, "10fold_idx", f"{split}_idx-0.txt"),
                   np.arange(offset, offset + num), fmt="%d")
        offset += num
    return base


# OGB's molhiv vocabularies: 9 atom fields, 3 bond fields
MOLHIV_ATOM_DIMS = [119, 4, 12, 12, 10, 6, 6, 2, 2]
MOLHIV_BOND_DIMS = [5, 6, 2]


def write_molhiv_dataset(root, num_graphs=12000, seed=0,
                         fractions=(0.8, 0.1, 0.1)):
    """``num_graphs`` molhiv-like molecules (``make_molhiv_like``'s chains
    and chords, 9 atom and 3 bond fields, a binary label) as the raw
    csv.gz files of an OGB graph-property dataset
    (``data/loaders.py::load_ogb_data``: each undirected bond once) under
    ``<root>/ogbg-molhiv/ogbg_molhiv/raw``, and one split,
    ``<root>/ogbg-molhiv/10fold_idx/{train,val,test}_idx-1.txt``, of
    ``fractions`` of a seeded permutation.  Returns the dataset
    directory ``<root>/ogbg-molhiv`` (the directional CLI's
    ``--data_root`` is ``root``; the GSN CLI's ``--root_folder`` is
    ``root``'s parent when ``root`` ends in ``ogb``)."""
    base = os.path.join(root, "ogbg-molhiv")
    raw = os.path.join(base, "ogbg_molhiv", "raw")
    os.makedirs(raw, exist_ok=True)
    os.makedirs(os.path.join(base, "10fold_idx"), exist_ok=True)
    graphs = _molecule_graphs(num_graphs, seed, MOLHIV_ATOM_DIMS,
                              MOLHIV_BOND_DIMS)
    files = {name: [] for name in ("edge", "edge-feat", "node-feat",
                                   "num-node-list", "num-edge-list",
                                   "graph-label")}
    for g in graphs:
        src, dst = g["edge_index"]
        half = src < dst
        files["edge"].append(np.stack([src[half], dst[half]], 1))
        files["edge-feat"].append(g["edge_features"][half])
        files["node-feat"].append(g["x"])
        files["num-node-list"].append([[g["x"].shape[0]]])
        files["num-edge-list"].append([[int(half.sum())]])
        files["graph-label"].append([[int(g["y"])]])
    for name, parts in files.items():
        rows = np.concatenate([np.asarray(p) for p in parts])
        with gzip.open(os.path.join(raw, f"{name}.csv.gz"), "wt",
                       compresslevel=1) as f:
            f.write("".join(",".join(map(str, r)) + "\n" for r in rows))
    order = np.random.RandomState(seed).permutation(num_graphs)
    n_train = int(round(fractions[0] * num_graphs))
    n_val = int(round(fractions[1] * num_graphs))
    for split, idx in (("train", order[:n_train]),
                       ("val", order[n_train:n_train + n_val]),
                       ("test", order[n_train + n_val:])):
        np.savetxt(os.path.join(base, "10fold_idx", f"{split}_idx-1.txt"),
                   np.sort(idx), fmt="%d")
    return base


def make_imdb_like(num_graphs=1000, seed=0):
    """IMDB-BINARY-shaped ego-networks as (nodes, undirected edges,
    label): node 0 (the ego) is linked to every other node, and the
    others are grouped into about (n-1)/5.2 "movies" of 3 to 11 actors,
    each a clique.  Sizes are 12 plus a gamma draw of mean 8.2 (at most
    136; the largest draw is set to 136, IMDB-BINARY's largest graph),
    so a set of 1,000 has IMDB-BINARY's scale: about 19.8 nodes and 96
    undirected edges a graph.  Labels alternate, and class 1's movies
    hold one actor more at most."""
    rng = np.random.RandomState(seed)
    sizes = 12 + np.minimum(rng.gamma(1.0, 8.2, num_graphs).astype(int),
                            124)
    sizes[np.argmax(sizes)] = 136
    out = []
    for i, n in enumerate(sizes):
        label = i % 2
        edges = {(0, v) for v in range(1, n)}
        alters = np.arange(1, n)
        for _ in range(max(1, int(round((n - 1) / 5.2)))):
            cast = rng.choice(alters, min(n - 1, rng.randint(3, 12 + label)),
                              replace=False)
            edges.update((int(min(a, b)), int(max(a, b)))
                         for a in cast for b in cast if a < b)
        out.append((int(n), sorted(edges), label))
    return out


def write_imdb_dataset(root, num_graphs=1000, seed=0, name="IMDBBINARY"):
    """``make_imdb_like`` in the TU text layout the GSN CLI reads for
    ``--dataset social --dataset_name <name>``
    (``data/loaders.py::load_tu_data``; one node tag, so one input
    column) under ``<root>/social/<name>``, with the ten stratified folds
    ``10fold_idx/{train,test}_idx-{1..10}.txt``
    (``data/splits.py::separate_data_given_split``).  Returns the
    dataset directory."""
    path = os.path.join(root, "social", name)
    os.makedirs(os.path.join(path, "10fold_idx"), exist_ok=True)
    graphs = make_imdb_like(num_graphs, seed)
    lines = [str(len(graphs))]
    for n, edges, label in graphs:
        adj = [[] for _ in range(n)]
        for u, v in edges:
            adj[u].append(v)
            adj[v].append(u)
        lines.append(f"{n} {label}")
        lines += [f"0 {len(nb)} " + " ".join(map(str, nb)) for nb in adj]
    with open(os.path.join(path, f"{name}.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    labels = np.array([label for _n, _e, label in graphs])
    for fold, (train, test) in enumerate(
            stratified_kfold_indices(labels, 10, seed)):
        for split, idx in (("train", train), ("test", test)):
            np.savetxt(os.path.join(path, "10fold_idx",
                                    f"{split}_idx-{fold + 1}.txt"),
                       idx, fmt="%d")
    return path


def rook_and_shrikhande():
    """The two SRG(16,6,2,2) graphs as (n, edges): the 4x4 rook's graph
    (two cells adjacent in one row or one column; each row is a K4) and
    the Shrikhande graph (Z4 x Z4, neighbours at +-(0,1), +-(1,0),
    +-(1,1); it has no K4).  1-WL cannot tell them apart."""
    cells = [(i, j) for i in range(4) for j in range(4)]
    rook = [(4 * a + b, 4 * c + d) for (a, b) in cells for (c, d) in cells
            if (a, b) < (c, d) and (a == c or b == d)]
    steps = {(0, 1), (0, 3), (1, 0), (3, 0), (1, 1), (3, 3)}
    shrikhande = [(4 * a + b, 4 * c + d) for (a, b) in cells
                  for (c, d) in cells if (a, b) < (c, d)
                  and ((c - a) % 4, (d - b) % 4) in steps]
    return [(16, rook), (16, shrikhande)]


def write_sr16622(root):
    """``<root>/SR_graphs/sr16622/sr16622.g6`` holding
    ``rook_and_shrikhande()`` (the SR loader's layout); returns the
    dataset directory."""
    path = os.path.join(root, "SR_graphs", "sr16622")
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "sr16622.g6"), "w") as f:
        for n, edges in rook_and_shrikhande():
            f.write(write_graph6(n, edges) + "\n")
    return path
