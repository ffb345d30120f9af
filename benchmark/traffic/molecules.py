"""The one generator of the benchmark's traffic: synthetic molecules.

Each molecule is a chain of atoms closed into rings: ``atoms`` [lo, hi]
bounds its atom count, ``rings`` is the mean number of ring closures (a
bond from atom u to atom u + s - 1, which closes a ring of s atoms, s
from ``ring_sizes``; a closure that repeats a bond is dropped), and its
categorical atom and bond fields are drawn uniformly.  The atom counts (even over [lo, hi]), the ring counts (each
molecule the floor or the ceiling of ``rings``) and the ring sizes (the
list repeated) are the same multiset for every seed, in the seed's
order, so a seed changes which molecule is which and where its rings
close, and the amount of work barely.  The means follow the published
dataset's atoms and bonds (a molecule's bonds are its atoms - 1 + its
rings).  All graphs are drawn at once, so that ogbg-molhiv's 41,127
molecules take well under a second of set-up; the generator lives here
so that a change to the program cannot move the yardstick.
``make_splits`` reads a traffic file's ``data`` parameters and returns
the splits as the program's loaders return them:

- ``layout: "zinc"`` — the ZINC loader's graphs: ``x`` [n, 1] atom
  types, ``edge_index`` both directions in row-major order of the
  symmetric bond matrix, ``edge_features`` [E, 1] bond types
  ``bond_offset``.., a float32 normal target;
- ``layout: "ogb"`` — the OGB loader's graphs: ``x`` [n, F] atom
  fields, each bond once (i < j, in order) and then reversed,
  ``edge_features`` [E, B] the same fields in both directions, a float32
  [1] binary label.

Every split is drawn from its own stream of ``--seed``, so the same
seed gives the same molecules.  Imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def stream(seed: int, *keys: int) -> np.random.RandomState:
    """A numpy stream of ``seed`` (any whole number) and ``keys``."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF,
             *keys]
    state = np.random.SeedSequence(words).generate_state(1)[0]
    return np.random.RandomState(int(state))


def molecules(num: int, rng: np.random.RandomState, atom_dims, bond_dims,
              atoms, rings: float, ring_sizes):
    """``num`` molecules as arrays: atoms per graph [num], each graph's
    bonds (i < j, sorted within the graph) as graph-local pairs with the
    bonds per graph, atom fields [sum n, F], bond fields [bonds, B] and
    a label draw [num]."""
    lo, hi = atoms
    if lo < max(ring_sizes):
        raise ValueError("a molecule must hold its largest ring")
    n = rng.permutation(lo + np.arange(num) * (hi - lo + 1) // num)
    n = n.astype(np.int64)
    whole = int(rings)
    r = rng.permutation(whole + (np.arange(num)
                                 < round((rings - whole) * num)))
    off = np.concatenate([[0], np.cumsum(n)])
    total = int(off[-1])
    g_of = np.repeat(np.arange(num), n)
    # the chain: i -- i + 1 inside each graph
    first = np.arange(total)[np.arange(total) + 1 < off[g_of + 1]]
    c_of = np.repeat(np.arange(num), r)
    size = rng.permutation(np.resize(np.asarray(ring_sizes, np.int64),
                                     len(c_of)))
    u = (rng.rand(len(c_of)) * (n[c_of] - size + 1)).astype(np.int64)
    a = np.concatenate([first, off[c_of] + u])
    b = np.concatenate([first + 1, off[c_of] + u + size - 1])
    key = np.unique(a * total + b)          # sorted: by graph, then i, j
    a, b = key // total, key % total
    per = np.bincount(g_of[a], minlength=num)
    x = np.stack([rng.randint(0, d, total) for d in atom_dims],
                 1).astype(np.int64)
    ef = np.stack([rng.randint(0, d, len(a)) for d in bond_dims],
                  1).astype(np.int64)
    label = rng.rand(num) > 0.5
    return n, off, a - off[g_of[a]], b - off[g_of[a]], per, x, ef, label


def _graphs(parts, layout: str, targets=None,
            bond_offset: int = 0) -> List[Dict]:
    n, off, a, b, per, x, ef, label = parts
    e_off = np.concatenate([[0], np.cumsum(per)])
    out = []
    for g in range(len(n)):
        s, t = a[e_off[g]:e_off[g + 1]], b[e_off[g]:e_off[g + 1]]
        f = ef[e_off[g]:e_off[g + 1]]
        xg = x[off[g]:off[g + 1]]
        if layout == "zinc":
            src = np.concatenate([s, t])
            dst = np.concatenate([t, s])
            order = np.lexsort((dst, src))
            out.append({"x": xg[:, :1],
                        "edge_index": np.stack([src, dst])[:, order],
                        "edge_features": (np.concatenate([f, f])[order, :1]
                                          + bond_offset),
                        "y": np.float32(targets[g])})
        else:
            out.append({"x": xg,
                        "edge_index": np.stack([np.concatenate([s, t]),
                                                np.concatenate([t, s])]),
                        "edge_features": np.concatenate([f, f]),
                        "y": np.asarray([label[g]], np.float32)})
    return out


def make_splits(traffic: Dict, seed: int) -> Dict[str, List[Dict]]:
    """{split name: graphs} of a traffic file's ``data`` parameters."""
    p = traffic["data"]
    shape = dict(atom_dims=p["atom_dims"], bond_dims=p["bond_dims"],
                 atoms=tuple(p["atoms"]), rings=p["rings"],
                 ring_sizes=p["ring_sizes"])
    names = list(p["splits"])
    if p["layout"] == "zinc":
        out = {}
        for i, name in enumerate(names):
            num = p["splits"][name]
            parts = molecules(num, stream(seed, 1 + i), **shape)
            targets = stream(seed, 100 + i).randn(num)
            out[name] = _graphs(parts, "zinc", targets, p["bond_offset"])
        return out
    if p["layout"] == "ogb":
        total = sum(p["splits"].values())
        graphs = _graphs(molecules(total, stream(seed, 1), **shape), "ogb")
        order = stream(seed, 2).permutation(total)
        out, at = {}, 0
        for name in names:
            idx = np.sort(order[at:at + p["splits"][name]])
            out[name] = [graphs[j] for j in idx]
            at += p["splits"][name]
        return out
    raise ValueError(f"unknown layout {p['layout']!r}")
