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
splits) runs on them; ``write_sr16622`` writes the two strongly regular
graphs of SR(16,6,2,2) for the isomorphism mode.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from .directional import assemble_directions
from .encoding import encode
from .pipeline import generate_dataset
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
