"""Plain PyTorch pieces of the reference GSN models (SURVEY.md §3), in
float32 with TF32 off: the batch as a disjoint union of the graphs,
batch norm over a batch's rows, dense layers, Adam, the losses and
ROC-AUC, and the initial parameters a seed gives.  Nothing here imports
the program; parameters are a dict of tensors keyed by the program's
parameter names, so the harness hands one set to both sides.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch.nn import functional as F

BN_EPS, BN_MOMENTUM = 1e-5, 0.1
ADAM = dict(beta1=0.9, beta2=0.999, eps=1e-8)


class Batch:
    """Graphs concatenated in order: node rows, then edge rows."""

    def __init__(self, graphs: Sequence[Dict], ids: Sequence[np.ndarray],
                 device):
        n = [g["x"].shape[0] for g in graphs]
        off = np.concatenate([[0], np.cumsum(n)])[:-1]
        ei = np.concatenate([g["edge_index"] + o
                             for g, o in zip(graphs, off)], 1)

        def cat(arrays, dtype=torch.long):
            return torch.as_tensor(np.concatenate(arrays, 0), dtype=dtype,
                                   device=device)

        self.num_graphs = len(graphs)
        self.num_nodes = int(sum(n))
        self.x = cat([g["x"].reshape(len(g["x"]), -1) for g in graphs])
        self.ef = cat([g["edge_features"].reshape(
            g["edge_index"].shape[1], -1) for g in graphs])
        self.ids = cat(list(ids))
        self.src = torch.as_tensor(ei[0], device=device)
        self.dst = torch.as_tensor(ei[1], device=device)
        self.node_graph = torch.as_tensor(
            np.repeat(np.arange(len(graphs)), n), device=device)
        self.y = cat([np.asarray(g["y"], np.float32).reshape(1)
                      for g in graphs], torch.float32)


def full_f32(tf32: bool = False) -> None:
    """Matmuls in full f32 (the control passes ``tf32=True``)."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def linear(x, params, name, bias=True):
    y = x @ params[f"{name}.weight"].t()
    return y + params[f"{name}.bias"] if bias else y


def batch_norm(x, params, stats, name, train):
    """BatchNorm1d over the rows of ``x`` (biased variance to normalise,
    unbiased into the running variance); updates ``stats[name]``."""
    if train:
        mean = x.mean(0)
        var = x.var(0, unbiased=False)
        n = x.shape[0]
        with torch.no_grad():
            rm, rv = stats.get(name, (torch.zeros_like(mean),
                                      torch.ones_like(var)))
            unb = var.detach() * n / max(n - 1, 1)
            stats[name] = ((1 - BN_MOMENTUM) * rm + BN_MOMENTUM * mean,
                           (1 - BN_MOMENTUM) * rv + BN_MOMENTUM * unb)
    else:
        mean, var = stats.get(name, (torch.zeros(x.shape[1],
                                                 device=x.device),
                                     torch.ones(x.shape[1],
                                                device=x.device)))
    y = (x - mean) / torch.sqrt(var + BN_EPS)
    return y * params[f"{name}.weight"] + params[f"{name}.bias"]


def mlp2(x, params, stats, name, train):
    """dense_0, batch norm, relu, dense_1."""
    h = linear(x, params, f"{name}.dense_0")
    h = F.relu(batch_norm(h, params, stats, f"{name}.bn_0", train))
    return linear(h, params, f"{name}.dense_1")


def sum_rows(rows, index, num):
    return torch.zeros(num, rows.shape[1], dtype=rows.dtype,
                       device=rows.device).index_add_(0, index, rows)


def l1_loss(pred, y):
    return (pred.reshape(-1) - y).abs().mean()


def bce_loss(pred, y):
    return F.binary_cross_entropy_with_logits(pred.reshape(-1), y)


def roc_auc(y: np.ndarray, score: np.ndarray) -> float:
    """Area under the ROC curve, tied scores at their mean rank."""
    y = np.asarray(y, np.float64).ravel()
    s = np.asarray(score, np.float64).ravel()
    order = np.argsort(s, kind="mergesort")
    ranks = np.empty(len(s))
    sorted_s = s[order]
    starts = np.r_[0, np.flatnonzero(np.diff(sorted_s)) + 1]
    ends = np.r_[starts[1:], len(s)]
    for a, b in zip(starts, ends):
        ranks[order[a:b]] = (a + b + 1) / 2.0
    pos, neg = (y == 1).sum(), (y == 0).sum()
    return float((ranks[y == 1].sum() - pos * (pos + 1) / 2) / (pos * neg))


def decayed(g: torch.Tensor, p: torch.Tensor,
            weight_decay: float) -> torch.Tensor:
    """The gradient Adam's moments take under torch's L2 weight decay:
    ``g + weight_decay * p`` (``g`` itself at 0)."""
    return g.add(p, alpha=weight_decay) if weight_decay else g


def adam_step(params: Dict[str, torch.Tensor], grads, moments, step: int,
              lr: float, weight_decay: float = 0.0) -> None:
    """One Adam step in place of ``params``, with torch's L2 weight decay
    (added to the gradient before the moments)."""
    b1, b2, eps = ADAM["beta1"], ADAM["beta2"], ADAM["eps"]
    with torch.no_grad():
        for name, p in params.items():
            g = decayed(grads[name], p, weight_decay)
            m, v = moments.setdefault(name, (torch.zeros_like(p),
                                             torch.zeros_like(p)))
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            moments[name] = (m, v)
            denom = v.sqrt() / math.sqrt(1 - b2 ** step) + eps
            p -= lr / (1 - b1 ** step) * m / denom


# ---- initial parameters ----------------------------------------------------

# std of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def init_params(spec: List[Tuple[str, Tuple[int, ...], str]], seed: int,
                device) -> Dict[str, torch.Tensor]:
    """The initial parameters of ``spec`` ((name, shape, kind) in order)
    from ``seed``, drawn in one call on ``device``: ``lecun`` a normal of
    std sqrt(1/fan_in) truncated at 2 std, ``xavier`` uniform in
    +-sqrt(6/(rows+cols)), ``ones``, ``zeros``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    drawn = [int(np.prod(s)) for _n, s, k in spec if k in ("lecun",
                                                            "xavier")]
    u = torch.rand(sum(drawn), generator=gen, device=device)
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    out, at = {}, 0
    for name, shape, kind in spec:
        if kind in ("ones", "zeros"):
            out[name] = (torch.ones if kind == "ones" else torch.zeros)(
                shape, device=device)
            continue
        n = int(np.prod(shape))
        r = u[at:at + n].reshape(shape)
        at += n
        if kind == "lecun":
            std = math.sqrt(1.0 / shape[-1]) / _TRUNC_STD
            t = torch.erfinv(2.0 * (lo + (hi - lo) * r) - 1.0)
            out[name] = t * (std * math.sqrt(2.0))
        elif kind == "xavier":
            lim = math.sqrt(6.0 / sum(shape))
            out[name] = (2.0 * r - 1.0) * lim
        else:
            raise ValueError(f"unknown init {kind!r}")
    return out


def train_steps(model, params, batches, masks, lr: float, steps: int,
                weight_decay: float = 0.0):
    """``steps`` steps of ``model`` (its ``forward(params, stats, batch,
    train, masks)`` and ``loss``) from ``params`` under Adam with L2
    ``weight_decay``: (losses, the first step's gradients as Adam's
    moments take them, the decay added, the parameters after the steps,
    BN statistics after the first step and after the last)."""
    params = {k: v.detach().clone() for k, v in params.items()}
    stats, moments = {}, {}
    losses, first, stats1 = [], None, None
    for k in range(steps):
        leaves = {n: p.detach().requires_grad_(True)
                  for n, p in params.items()}
        pred = model.forward(leaves, stats, batches[k], True,
                             masks[k] if masks else None)
        loss = model.loss(pred, batches[k].y)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        grads = {n: (g if g is not None else torch.zeros_like(p))
                 for (n, p), g in zip(leaves.items(), grads)}
        losses.append(float(loss.detach()))
        if first is None:
            first = {n: decayed(g, params[n], weight_decay).detach().clone()
                     for n, g in grads.items()}
            stats1 = dict(stats)
        adam_step(params, grads, moments, k + 1, lr, weight_decay)
    return losses, first, params, stats1, stats


@torch.no_grad()
def evaluate(model, params, stats, graphs, ids, device, block: int = 1024):
    """(mean loss over the graphs, the split's metric, each graph's
    prediction) in eval mode."""
    preds, ys = [], []
    for i in range(0, len(graphs), block):
        b = Batch(graphs[i:i + block], ids[i:i + block], device)
        preds.append(model.forward(params, stats, b, False, None)
                     .reshape(-1))
        ys.append(b.y)
    pred, y = torch.cat(preds), torch.cat(ys)
    loss = float(model.loss(pred, y))
    pred, y = pred.cpu().numpy(), y.cpu().numpy()
    return loss, model.metric(pred, y), pred, y
