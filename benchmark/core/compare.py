"""How ``correct`` is decided: the plain reference recomputes what the
program's set-up steps produced, from the same molecules and initial
parameters, and each number compared is held to its limit.

Readings of either side: ``losses`` (each step), ``grad1`` (each leaf's
first gradient), ``params`` (each leaf after the steps), ``stats1`` and
``stats`` (the batch-norm running statistics after the first step and
after the last), ``eval`` (val loss and metric) and ``eval_rows`` (what
the val evaluation reads back: each batch's loss, or each graph's
prediction where the split's metric needs them).  The program's
encoded ids are matched against the reference's own cycle counts,
encoded.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional

import numpy as np
import torch

import registry


def step_rows(n_train: int, batch: int, seed: int, steps: int):
    """The train rows of the set-up's steps, all different: a batch of
    rows for each step, drawn from the seed."""
    rng = np.random.RandomState(seed)
    pick = rng.permutation(n_train)[:batch * steps]
    return [np.sort(pick[k * batch:(k + 1) * batch]) for k in range(steps)]


def batch_orders(rows, seed: int):
    """Each step's rows in the order its batch holds them: the trainer
    shuffles a ``train_epoch`` call's rows with its stream
    (``RandomState(seed)``: one shuffle of the call's rows, then one
    draw for its step)."""
    rng = np.random.RandomState(seed)
    out = []
    for idx in rows:
        order = np.arange(len(idx))
        rng.shuffle(order)
        rng.randint(0, 2 ** 31 - 1)
        out.append(idx[order])
    return out


def count_ids(config, splits, device):
    """The reference's encoded ids of every graph (split order) and the
    vocabulary sizes."""
    cyc = registry.module("reference", "ref_cycles")
    c = config["counts"]
    graphs = [g for n in splits for g in splits[n]]
    counts = cyc.count_cycles(graphs, c["k_max"], c["scope"], c["induced"],
                              device)
    return cyc.one_hot_unique(counts)


def bn_stats(buffers: Dict[str, torch.Tensor], device):
    """The program's batch-norm running statistics by layer name."""
    return {n[:-len(".running_mean")]: (
        buffers[n].to(device),
        buffers[n[:-len("mean")] + "var"].to(device))
        for n in buffers if n.endswith(".running_mean")}


def stat_leaves(stats) -> Dict[str, torch.Tensor]:
    """{layer.running_mean / layer.running_var: values} on the CPU."""
    out = {}
    for name, (mean, var) in stats.items():
        out[f"{name}.running_mean"] = mean.float().cpu()
        out[f"{name}.running_var"] = var.float().cpu()
    return out


def reference_readings(config, splits, ids, dims, init, masks, seed: int,
                       device, tf32: bool = False,
                       state: Optional[Dict] = None) -> Dict:
    """The reference's readings of the set-up's steps from ``init``, and
    of the evaluation of the val split from ``state`` (the program's
    parameters and batch-norm statistics after those steps, which the
    steps' own readings check; the reference's own without it);
    ``tf32`` computes them in TF32 (the control)."""
    common = registry.module("reference", "ref_common")
    ref = registry.module("reference", config["name"])
    flags = config["flags"]
    model = ref.Model(flags, dims)
    spec = ref.spec(flags, dims)
    if {n: tuple(s) for n, s, _k in spec} != \
            {n: tuple(p.shape) for n, p in init.items()}:
        raise RuntimeError("the reference's parameters differ from the "
                           "ones handed to the program")
    common.full_f32(tf32)
    try:
        names = list(splits)
        at = {n: sum(len(splits[m]) for m in names[:names.index(n)])
              for n in names}
        train, val = splits["train"], splits["val"]
        steps = len(masks)
        hyper = registry.module("drivers", config["driver"]).hyper(flags)
        batch = hyper["batch_size"]
        batches = []
        for rows in batch_orders(step_rows(len(train), batch, seed, steps),
                                 seed):
            batches.append(common.Batch(
                [train[i] for i in rows],
                [ids[at["train"] + i] for i in rows], device))
        params = {n: p.to(device) for n, p in init.items()}
        losses, grad1, after, stats1, stats = common.train_steps(
            model, params, batches,
            [[m.to(device) for m in ms] for ms in masks]
            if any(masks) else None, hyper["lr"], steps,
            hyper["weight_decay"])
        ev_params, ev_stats = after, stats
        if state is not None:
            ev_params = {n: p.to(device) for n, p in state["params"].items()}
            ev_stats = bn_stats(state["stats"], device)
        loss, metric, pred, y = common.evaluate(
            model, ev_params, ev_stats, val,
            ids[at["val"]:at["val"] + len(val)], device)
    finally:
        common.full_f32(False)
    batch_loss = [float(model.loss(torch.as_tensor(pred[i:i + batch]),
                                   torch.as_tensor(y[i:i + batch])))
                  for i in range(0, len(val), batch)]
    return {"losses": losses,
            "grad1": {n: g.float().cpu() for n, g in grad1.items()},
            "params": {n: p.float().cpu() for n, p in after.items()},
            "stats1": stat_leaves(stats1), "stats": stat_leaves(stats),
            "eval": (loss, metric),
            "eval_rows": {"loss": batch_loss,
                          "n": [len(val[i:i + batch])
                                for i in range(0, len(val), batch)],
                          "pred": pred}}


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float]):
    """Each leaf's gap of norms over the larger of its reference norm and
    the median leaf's."""
    med = statistics.median(ref.values())
    return [abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in ref]


def _worst_leaf(prog: Dict[str, float], ref: Dict[str, float]) -> float:
    return max(_leaf_gaps(prog, ref))


def stats_gap(prog: Dict[str, torch.Tensor],
              ref: Dict[str, torch.Tensor]) -> float:
    """The worst leaf's distance from the reference's running statistics
    (the norm of the difference over the larger of the leaf's norm and
    the median leaf's); 1 where the program lacks a leaf."""
    if not ref or set(ref) - set(prog):
        return 1.0
    norm = {n: float(r.norm()) for n, r in ref.items()}
    med = statistics.median(norm.values())
    return max(float((prog[n] - r).norm()) / max(norm[n], med, 1e-30)
               for n, r in ref.items())


def row_gap(prog: Dict, ref: Dict) -> float:
    """The largest gap over the val evaluation's rows, each over the
    larger of the reference's row and the median row (magnitudes):
    each graph's prediction where the program read them back, else each
    batch's loss; 1 where the rows do not match up."""
    if prog["pred"] is not None:
        p, r = np.ravel(prog["pred"]), np.ravel(ref["pred"])
    else:
        if list(prog["n"]) != list(ref["n"]):
            return 1.0
        p, r = np.asarray(prog["loss"]), np.asarray(ref["loss"])
    if p.shape != r.shape or not r.size:
        return 1.0
    scale = np.maximum(np.abs(r), max(float(np.median(np.abs(r))), 1e-30))
    return float(np.max(np.abs(p - r) / scale))


def numbers(prog: Dict, ref: Dict, init: Dict, dropout: Optional[float],
            ids_prog: Optional[List[np.ndarray]] = None,
            ids_ref: Optional[List[np.ndarray]] = None,
            dims_prog=None, dims_ref=None) -> Dict[str, float]:
    """Every number that can be compared, from two sides' readings."""
    out = {}
    gaps = [abs(a - b) / max(abs(b), 1e-30)
            for a, b in zip(prog["losses"], ref["losses"])]
    out["loss1_gap"] = gaps[0]
    out["loss_gap"] = max(gaps)
    g_ref = {n: float(g.norm()) for n, g in ref["grad1"].items()}
    g_prog = {n: float(prog["grad1"][n].norm()) for n in g_ref}
    out["grad_gap"] = _worst_leaf(g_prog, g_ref)
    # the median leaf's: steady where rounding moves a few leaves' first
    # gradient far (zinc's batch-norm leaves, PERF.md §2)
    out["grad_med_gap"] = statistics.median(_leaf_gaps(g_prog, g_ref))
    # leaves whose reference gradient is nought to rounding move under
    # Adam by round-off alone: left out of the change
    med = statistics.median(g_ref.values())
    moved = [n for n in g_ref if g_ref[n] >= 1e-3 * med]
    d_ref = {n: float((ref["params"][n] - init[n].cpu()).norm())
             for n in moved}
    d_prog = {n: float((prog["params"][n] - init[n].cpu()).norm())
              for n in moved}
    out["change_gap"] = _worst_leaf(d_prog, d_ref)
    (lp, mp), (lr, mr) = prog["eval"], ref["eval"]
    out["eval_loss_gap"] = abs(lp - lr) / max(abs(lr), 1e-30)
    out["eval_metric_gap"] = abs(mp - mr) / max(abs(mr), 1e-30)
    out["eval_row_gap"] = row_gap(prog["eval_rows"], ref["eval_rows"])
    out["stats1_gap"] = stats_gap(prog["stats1"], ref["stats1"])
    out["stats_gap"] = stats_gap(prog["stats"], ref["stats"])
    if ids_prog is not None:
        if list(dims_prog) != list(dims_ref):
            out["id_mismatch"] = float(sum(a.size for a in ids_ref))
        else:
            out["id_mismatch"] = float(sum(
                int((np.asarray(a) != b).sum())
                for a, b in zip(ids_prog, ids_ref)))
    if dropout:
        out["mask_keep_gap"] = mask_keep_gap(prog.get("masks", []),
                                             prog.get("mask_rows", []),
                                             1.0 - dropout,
                                             prog.get("mask_sites", 0))
    return out


def mask_keep_gap(masks, rows, keep: float, sites: int) -> float:
    """The dropout stage by itself: the largest distance of a mask's
    kept share (over the batch's real rows) from ``keep``; 1 when a
    step drew another number of masks than the model has sites, or a
    mask holds anything but 0 and 1."""
    worst = 0.0
    for ms, (n_rows, g_rows) in zip(masks, rows):
        if len(ms) != sites:
            return 1.0
        for m in ms:
            # node sites span the node slots, graph sites the graph slots
            real = m[:n_rows if m.shape[0] >= n_rows else g_rows].float()
            if not bool(((real == 0) | (real == 1)).all()):
                return 1.0
            worst = max(worst, abs(float(real.mean()) - keep))
    return worst


def check(config, splits, first, init, seed: int, device, prog_ids,
          prog_dims, counted=None) -> Dict[str, float]:
    """Every number of the program's set-up readings ``first`` against
    the reference's; ``counted``: the reference's (ids, dims), if they
    are already counted."""
    ids, dims = counted or count_ids(config, splits, device)
    ref = reference_readings(config, splits, ids, dims, init,
                             first["masks"], seed, device, state=first)
    return numbers(first, ref, init, config["check"].get("dropout"),
                   prog_ids, ids, prog_dims, dims)


def judge(values: Dict[str, float], limits: Dict[str, float]) -> Dict:
    """{name: {value, limit}} of the compared numbers, and whether all
    hold (a number that is not finite fails)."""
    checks = {n: {"value": values.get(n, float("nan")), "limit": lim}
              for n, lim in limits.items()}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return checks, ok
