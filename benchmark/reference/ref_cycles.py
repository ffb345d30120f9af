"""Plain cycle counting and the one-hot-unique encoding, written from
the GSN definitions (SURVEY.md §3), independent of the program.

A node's global-scope count of the k-cycle is the number of k-cycles
of the graph (as subgraphs) that pass through it; an edge's local-scope
count is the number of k-cycles that use it, counted for each direction
of the edge; ``induced`` keeps the cycles without a chord.  Cycles are
found by walking simple paths from each node through larger nodes only
and closing them at the start, all graphs at once, on any device.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


def _union(graphs: Sequence[Dict], device):
    """Node offsets, edge offsets and the undirected adjacency (CSR over
    both directions, neighbours sorted) of all graphs."""
    n = np.array([g["x"].shape[0] for g in graphs], np.int64)
    e = np.array([g["edge_index"].shape[1] for g in graphs], np.int64)
    n_off = np.concatenate([[0], np.cumsum(n)])
    e_off = np.concatenate([[0], np.cumsum(e)])
    ei = np.concatenate([g["edge_index"] + o
                         for g, o in zip(graphs, n_off[:-1])], 1)
    ei = torch.as_tensor(ei, device=device)
    total = int(n_off[-1])
    keys = torch.unique(torch.cat([ei[0] * total + ei[1],
                                   ei[1] * total + ei[0]]))
    src, dst = keys // total, keys % total
    ptr = torch.zeros(total + 1, dtype=torch.long, device=device)
    ptr[1:] = torch.cumsum(torch.bincount(src, minlength=total), 0)
    return n_off, e_off, ei, total, keys, ptr, dst


def _cycles(total, ptr, nbr, k_max, device):
    """{k: [C, k] node sequences}: each k-cycle once, from its smallest
    node, for k = 3..k_max."""
    deg = ptr[1:] - ptr[:-1]
    src = torch.repeat_interleave(torch.arange(total, device=device), deg)
    keep = nbr > src
    paths = torch.stack([src[keep], nbr[keep]], 1)
    found = {}
    for length in range(2, k_max + 1):
        if paths.numel() == 0:
            break
        last = paths[:, -1]
        reps = deg[last]
        row = torch.repeat_interleave(
            torch.arange(paths.shape[0], device=device), reps)
        first = ptr[last][row]
        step = torch.arange(row.numel(), device=device) - \
            torch.repeat_interleave(torch.cumsum(reps, 0) - reps, reps)
        w = nbr[first + step]
        p = paths[row]
        if length >= 3:
            # closing at the start; each cycle is walked both ways, keep
            # the walk whose second node is below its last
            close = (w == p[:, 0]) & (p[:, 1] < p[:, -1])
            found[length] = p[close]
        if length == k_max:
            break
        fresh = (w > p[:, 0]) & (p[:, 1:] != w[:, None]).all(1)
        paths = torch.cat([p[fresh], w[fresh, None]], 1)
    return found


def _chordless(cyc: torch.Tensor, keys: torch.Tensor, total: int):
    k = cyc.shape[1]
    ok = torch.ones(cyc.shape[0], dtype=torch.bool, device=cyc.device)
    for i in range(k):
        for j in range(i + 2, k):
            if i == 0 and j == k - 1:
                continue
            key = cyc[:, i] * total + cyc[:, j]
            at = torch.searchsorted(keys, key).clamp(max=keys.numel() - 1)
            ok &= keys[at] != key
    return ok


def count_cycles(graphs: Sequence[Dict], k_max: int, scope: str,
                 induced: bool, device="cpu") -> List[np.ndarray]:
    """Per graph, int64 counts of the 3..k_max cycles: [n, k_max - 2]
    per node (``scope="global"``) or [E, k_max - 2] per row of the
    graph's ``edge_index`` (``scope="local"``)."""
    n_off, e_off, ei, total, keys, ptr, nbr = _union(graphs, device)
    cycles = _cycles(total, ptr, nbr, k_max, device)
    rows = total if scope == "global" else ei.shape[1]
    counts = torch.zeros(rows, k_max - 2, dtype=torch.long, device=device)
    if scope == "local":
        order = torch.argsort(ei[0] * total + ei[1])
        ekeys = (ei[0] * total + ei[1])[order]
    for k in range(3, k_max + 1):
        cyc = cycles.get(k)
        if cyc is None or cyc.numel() == 0:
            continue
        if induced:
            cyc = cyc[_chordless(cyc, keys, total)]
        col = counts[:, k - 3]
        if scope == "global":
            col.index_add_(0, cyc.reshape(-1),
                           torch.ones(cyc.numel(), dtype=torch.long,
                                      device=device))
            continue
        a, b = cyc, torch.roll(cyc, -1, 1)
        for u, v in ((a, b), (b, a)):
            key = (u * total + v).reshape(-1)
            at = order[torch.searchsorted(ekeys, key)]
            col.index_add_(0, at, torch.ones_like(at))
    counts = counts.cpu().numpy()
    off = n_off if scope == "global" else e_off
    return [counts[off[i]:off[i + 1]] for i in range(len(graphs))]


def one_hot_unique(columns: Sequence[np.ndarray]
                   ) -> Tuple[List[np.ndarray], List[int]]:
    """Each column's values replaced by their rank among the distinct
    values of the whole dataset; returns (encoded arrays, vocabulary
    sizes)."""
    cat = np.concatenate(columns, 0)
    enc = np.empty_like(cat)
    dims = []
    for c in range(cat.shape[1]):
        uniq = np.unique(cat[:, c])
        dims.append(len(uniq))
        enc[:, c] = np.searchsorted(uniq, cat[:, c])
    out, at = [], 0
    for a in columns:
        out.append(enc[at:at + a.shape[0]])
        at += a.shape[0]
    return out, dims
