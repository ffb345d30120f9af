"""One run of one cell: set-up, the measured window, the profiled slice
(``--trace 1``), the check against the plain reference, and the result.

Set-up (``setup_s``, from the process's start to the window): the
kernels built or loaded, the molecules made from the seed, the program's
counting and encoding, the model with the harness's initial parameters,
the first steps that the check reads, and the whole warm-up epochs of
``fit`` (the traffic's ``window.warmup``) so that every train and eval
graph is captured.  The window runs whole epochs of ``fit`` until
``seconds`` have passed; ``epoch_s`` is its wall time over its epochs.
Then, with ``trace``, a slice of the window's calls on fixed subsets
runs under the profiler.  The check runs last, once the program's state
is freed.
"""

from __future__ import annotations

import gc
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

import compare
import devtrace
import registry
from program import Program, RunLog

CHECK_STEPS = 3
FORBIDDEN = ("jax", "jaxlib", "flax", "gsn_tpu")


def log(t_start: float, what: str) -> None:
    print(f"[bench] {time.perf_counter() - t_start:8.2f} s  {what}",
          file=sys.stderr, flush=True)


def seed32(seed: int) -> int:
    """The trainer's 32-bit seed of a run's seed (numpy streams take no
    more)."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF, 7]
    return int(np.random.SeedSequence(words).generate_state(1)[0] >> 1)


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX
    package's (compared whole)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def first_steps(prog, config, splits, s32: int) -> Dict:
    """The program's set-up steps on their rows, with what the dropout
    check needs: each step's real node and graph rows, and the sites."""
    rows = compare.step_rows(len(splits["train"]), prog.tcfg.batch_size,
                             s32, CHECK_STEPS)
    first = prog.first_steps(rows)
    first["mask_rows"] = [
        (sum(splits["train"][i]["x"].shape[0] for i in idx), len(idx))
        for idx in rows]
    first["mask_sites"] = config["check"].get("dropout_sites", 0)
    return first


def inputs(workload: str, seed: int,
           sizes: Optional[Dict[str, int]] = None):
    """(configuration, traffic, {split: molecules}) of a cell's run;
    ``sizes`` overrides the traffic's split sizes."""
    _work, config, traffic = registry.cell(workload)
    if sizes:
        traffic = dict(traffic, data=dict(traffic["data"], splits=sizes))
    splits = registry.module("traffic", "molecules").make_splits(traffic,
                                                                 seed)
    return config, traffic, splits


def make_program(config, splits, seed: int, device, prepared=None):
    """(the program with the harness's initial weights, those weights):
    drawn from the seed in the reference's names and shapes, for the id
    vocabulary the program's data path found."""
    ref = registry.module("reference", config["name"])
    common = registry.module("reference", "ref_common")
    driver = registry.module("drivers", config["driver"])
    held = {}

    def init_params(dims):
        held["init"] = common.init_params(ref.spec(config["flags"], dims),
                                          seed, device)
        return held["init"]

    prog = Program(driver, config["flags"], splits, seed32(seed), device,
                   init_params, prepared)
    return prog, held["init"]


def context(config, traffic, splits, prog, records, window_s: float
            ) -> Dict:
    """What the metrics read of a window: its epochs' ``records`` and
    seconds, the program's set-up readings and its driver's evaluated
    splits and hyperparameters (``run`` adds the set-up time and the
    profiled slice)."""
    return {"config": config, "traffic": traffic, "splits": splits,
            "window_s": window_s, "records": records,
            "prepare_s": prog.prepare_s, "capture_s": prog.capture_s,
            "dims": list(prog.dims), "eval_splits": prog.driver.EVAL_SPLITS,
            "hyper": prog.driver.hyper(config["flags"]),
            "work": registry.module("work", config["name"])}


def run(workload: str, seed: int, seconds: float, trace: bool, device,
        t_start: float, sizes: Optional[Dict[str, int]] = None,
        fault=None) -> Dict:
    """The result of one run (the dict printed as the last line).
    ``sizes`` overrides the traffic's split sizes and ``fault`` is
    called with the program before its first steps: both for tests."""
    cuda = torch.device(device).type == "cuda"
    s32 = seed32(seed)
    if cuda:
        from gsn_tpu_torch.ops.cuda import build
        build.build_all()
    log(t_start, "kernels built or loaded")
    config, traffic, splits = inputs(workload, seed, sizes)
    log(t_start, "molecules made")
    prog, init = make_program(config, splits, seed, device)
    log(t_start, f"program ready (data path {prog.prepare_s:.2f} s, "
        + ", ".join(f"{k} {v:.2f} s" for k, v in prog.timings.items())
        + ")")
    if fault is not None:
        fault(prog)
    first = first_steps(prog, config, splits, s32)
    prog_ids = prog.ids()
    prog_dims = list(prog.dims)
    log(t_start, "first steps")
    runlog = RunLog()
    for _ in range(traffic["window"].get("warmup", 1)):
        prog.epoch(runlog)                # whole warm-up epochs
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    log(t_start, "warm-up epoch; set-up done")
    warm = len(runlog.records)
    t0 = time.perf_counter()
    while True:
        prog.epoch(runlog)
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    records = runlog.records[warm:]
    log(t_start, f"window: {len(records)} epochs in {window_s:.3f} s ("
        + ", ".join(f"{r.get('epoch_s', 0):.3f}+{r['eval_s']:.3f}"
                    for r in records) + ")")
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    ctx = context(config, traffic, splits, prog, records, window_s)
    if trace:
        p = traffic["profile"]
        train_sub, eval_sub = prog.slice_subsets(
            p["train_batches"], p["eval_batches"], seed)
        prog.trainer.evaluate(prog.state, eval_sub)   # its batches, once
        ctx["slice"] = {"train": train_sub, "eval": eval_sub}
        ctx["trace"] = devtrace.profile_slice(
            lambda: prog.run_slice(train_sub, eval_sub))
        log(t_start, "profiled slice")
    steps = sum(r.get("steps", 1) for r in records)
    failed = sum(r.get("steps", 1) for r in records
                 if not all(np.isfinite(v) for k, v in r.items()
                            if k.endswith("_loss")))

    prog.close()
    del prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    values = compare.check(config, splits, first, init, s32, device,
                           prog_ids, prog_dims)
    checks, ok = compare.judge(values, config["check"]["limits"])
    log(t_start, "check done")

    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f"the run loaded {bad}")
    ctx["setup_s"] = setup_s
    metrics = {}
    for spec in registry.benchmark()["per_layer" if trace
                                     else "end_to_end"]:
        if workload not in spec.get("workloads", [workload]):
            continue
        v = registry.module("metrics", spec["name"]).read(ctx)
        if v is not None:
            metrics[spec["name"]] = {"value": v, "unit": spec["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    if trace:
        dev["busy_s"] = ctx["trace"]["busy_s"]
        dev["window_s"] = ctx["trace"]["wall_s"]
    out = {"correct": bool(ok), "attempted": steps, "failed": failed,
           "metrics": metrics, "device": dev}
    if trace:
        out["breakdown"] = devtrace.breakdown(ctx["trace"])
    out["readings"] = values      # every number, compared or not
    out["checks"] = checks        # the compared ones, last
    return out
