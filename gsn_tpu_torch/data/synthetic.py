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
"""

from __future__ import annotations

import numpy as np

from .directional import assemble_directions
from .encoding import encode
from .pipeline import generate_dataset
from gsn_tpu_torch.graphs.patterns import cycle_graph


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
