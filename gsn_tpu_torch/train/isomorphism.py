"""Graph-isomorphism disambiguation test (counterpart of
``gsn_tpu/train/isomorphism.py``; the reference's built-in correctness
fixture, ``train_test_funcs.py:262-277`` + ``main.py:160-199``).

A randomly-initialized GSN embeds every graph; two non-isomorphic graphs
are "distinguished" when their embeddings differ by more than ``eps`` in
L2.  GSN with induced 6-cycle identifiers must distinguish all pairs of
SR(25,12,5,6); a 1-WL MPNN must fail all pairs.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from gsn_tpu_torch.config import GSNConfig
from gsn_tpu_torch.graphs.container import batch_graphs, pad_cap
from gsn_tpu_torch.nn.models import build_model
from .loop import resolve_device


@torch.no_grad()
def embed(model: torch.nn.Module, graphs: List[Dict], batch_size: int = 16,
          device=None) -> np.ndarray:
    """Each graph's output under ``model`` in eval mode, every batch at
    one shared padded shape; ``model`` is moved to ``device`` (default:
    the card, as ``resolve_device``)."""
    device = resolve_device(device)
    model = model.to(device).eval()
    chunks = [graphs[i:i + batch_size]
              for i in range(0, len(graphs), batch_size)]
    node_cap = pad_cap(max(sum(g["x"].shape[0] for g in c) for c in chunks))
    edge_cap = pad_cap(max(sum(g["edge_index"].shape[1] for g in c)
                           for c in chunks))
    graph_cap = pad_cap(batch_size, 8)
    flow = getattr(model.cfg, "flow", "source_to_target")
    outs = []
    for chunk in chunks:
        data = batch_graphs(chunk, node_cap, edge_cap, graph_cap,
                            flow=flow).to(device)
        outs.append(model(data)[:len(chunk)].float().cpu().numpy())
    return np.concatenate(outs, axis=0)


def embed_graphs(graphs: List[Dict], cfg: GSNConfig, seed: int = 0,
                 batch_size: int = 16, device=None) -> np.ndarray:
    """Embed each graph with a freshly initialized model (no training),
    its weights drawn from ``torch.Generator`` seeded with ``seed``."""
    model = build_model(cfg, torch.Generator().manual_seed(seed))
    return embed(model, graphs, batch_size, device)


def pairwise_failures(embeddings: np.ndarray, eps: float = 1e-2,
                      p: int = 2) -> Tuple[np.ndarray, int]:
    """All-pairs distance + count of pairs closer than eps (reference
    torch.pdist at train_test_funcs.py:271-272)."""
    diff = embeddings[:, None, :] - embeddings[None, :, :]
    dists = np.linalg.norm(diff, ord=p, axis=-1)
    iu = np.triu_indices(len(embeddings), k=1)
    flat = dists[iu]
    return flat, int((flat < eps).sum())


def run_isomorphism_test(graphs: List[Dict], cfg: GSNConfig, seed: int = 0,
                         batch_size: int = 16, eps: float = 1e-2,
                         device=None):
    """Returns (num_pairs, num_not_distinguished, failure_fraction)."""
    emb = embed_graphs(graphs, cfg, seed, batch_size, device)
    flat, fails = pairwise_failures(emb, eps)
    return len(flat), fails, fails / len(flat)
