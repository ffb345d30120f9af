"""A model of the port's other CLI joins the harness as new files only.

On the CPU, a throwaway copy of ``benchmark/`` gains a driver of
``gsn_tpu_torch.cli_directional`` built on its public functions (the
directional data path with its vector fields, ``DGNNet`` in the
trainer, ``run_epochs``' loop body as one epoch), a configuration, its
work functions and entries in a copy of ``BENCHMARK.json``.  A run in
its own process drives it through ``Program``'s set-up, the first
steps the check reads, two epochs and every metric reader that needs no
profiler; then no file of the copy's core, metrics or ``ref_common``
may differ from the harness's own.  Its initial weights are the
model's own, so no reference of the model is needed.
"""

import filecmp
import json
import math
import os
import shutil
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

CONFIG = "dgn-molhiv-tiny"
WORKLOAD = CONFIG + ".fit"
SIZES = {"train": 32, "val": 16, "test": 16}      # 64 ogb molecules
FLAGS = {"--L": "2", "--hidden_dim": "8", "--out_dim": "8",
         "--type_net": "simple", "--residual": "True",
         "--readout": "mean", "--dropout": "0.3", "--batch_norm": "True",
         "--aggregators": "mean dir0-av", "--scalers": "identity",
         "--batch_size": "8", "--init_lr": "0.01", "--weight_decay": "3e-6",
         "--lr_reduce_factor": "0.5", "--lr_schedule_patience": "20",
         "--min_lr": "0.0001", "--id_scope": "local", "--k": "6",
         "--id_type": "cycle_graph", "--directions": "subgraphs",
         "--multiprocessing": "False"}

DRIVER = '''"""A throwaway driver of ``gsn_tpu_torch.cli_directional``."""

EVAL_SPLITS = ("val", "test")


def prepare(flags, splits, seed):
    from gsn_tpu_torch.cli_directional import build_parser, model_config
    from gsn_tpu_torch.data.directional import assemble_directions
    from gsn_tpu_torch.data.encoding import encode
    from gsn_tpu_torch.data.pipeline import generate_dataset
    from gsn_tpu_torch.graphs.patterns import resolve_pattern_vocabulary
    from gsn_tpu_torch.nn.dgn import compute_avg_d

    argv = [w for k, v in flags.items() for w in (k, str(v))]
    args = vars(build_parser().parse_args(argv + ["--seed", str(seed)]))
    names = list(splits)
    graphs = [g for n in names for g in splits[n]]
    graphs, _sizes = generate_dataset(
        graphs, resolve_pattern_vocabulary(args["id_type"], args["k"]),
        id_scope=args["id_scope"], induced=args["induced"])
    graphs, _e, d_id, _ed, _dd = encode(graphs, args["id_encoding"])
    out, at = {}, 0
    for n in names:
        out[n] = assemble_directions(
            graphs[at:at + len(splits[n])],
            directions=args["directions"].split(),
            id_scope=args["id_scope"], pos_enc_dim=args["pos_enc_dim"],
            norm=args["norm"])
        at += len(splits[n])
    cfg = model_config(args, compute_avg_d(out["train"]), 1)
    return args, out, cfg, list(d_id)


def trainer(args, model_cfg, train, device):
    from gsn_tpu_torch.cli_directional import trainer_config
    from gsn_tpu_torch.nn.dgn import DGNNet
    from gsn_tpu_torch.train.loop import Trainer
    return Trainer(model_cfg, trainer_config(args), train, device=device,
                   model=DGNNet(model_cfg))


def epoch(trainer, state, splits, logger):
    from gsn_tpu_torch.spans import since, snapshot, span
    snap = snapshot()
    state, train_loss = trainer.train_epoch(state, splits["train"])
    with span("eval") as ev:
        val_loss, val_roc = trainer.evaluate(state, splits["val"])
        test_loss, test_roc = trainer.evaluate(state, splits["test"])
    trainer.scheduler.step(-val_roc)
    spans, counts = since(snap)
    rec = dict(train_loss=train_loss, val_loss=val_loss, val_roc=val_roc,
               test_loss=test_loss, test_roc=test_roc,
               lr=trainer.scheduler.lr, eval_s=ev.seconds,
               **trainer.epoch_stats)
    rec.update({k: counts.get(k, 0) for k in ("eval.steps",
                                              "eval.captures")})
    rec["spans"] = spans
    logger.log(rec, step=state.epoch - 1)
    return state


def hyper(flags):
    return {"lr": float(flags["--init_lr"]),
            "weight_decay": float(flags["--weight_decay"]),
            "batch_size": int(flags["--batch_size"])}
'''

WORK = '''"""Work of the throwaway DGN: a dense d x d product a node a layer."""


def model_flops(flags, dims, graphs, train):
    fwd = (int(flags["--L"]) * 2 * int(flags["--hidden_dim"]) ** 2
           * sum(g["x"].shape[0] for g in graphs))
    return 3 * fwd if train else fwd


def kernel_work(flags, graphs, batches, train):
    return []
'''

RUN = '''import json, sys, time
T0 = time.perf_counter()
sys.path[:0] = [sys.argv[1], "benchmark/core"]
import torch
torch.manual_seed(0)
import cell
import registry
from program import Program, RunLog

SEED = 2 ** 33 + 7
config, traffic, splits = cell.inputs(%r, SEED, %r)
driver = registry.module("drivers", config["driver"])
s32 = cell.seed32(SEED)
built = []
make_trainer = driver.trainer


def keep_trainer(*args):
    built.append(make_trainer(*args))
    return built[-1]


def own_weights(dims):
    state = built[-1].init_state(seed=s32)
    return {n: p.detach().clone()
            for n, p in state.model.named_parameters()}


driver.trainer = keep_trainer
prog = Program(driver, config["flags"], splits, s32, "cpu", own_weights)
first = cell.first_steps(prog, config, splits, s32)
runlog = RunLog()
prog.epoch(runlog)
setup_s = time.perf_counter() - T0
t0 = time.perf_counter()
prog.epoch(runlog)
window_s = time.perf_counter() - t0
ctx = cell.context(config, traffic, splits, prog, runlog.records[1:],
                   window_s)
ctx["setup_s"] = setup_s
spec = registry.benchmark()
metrics = {m["name"]: registry.module("metrics", m["name"]).read(ctx)
           for m in spec["end_to_end"] + spec["per_layer"]
           if m["source"] != "device_trace"}
print(json.dumps({
    "metrics": metrics, "window_s": window_s,
    "losses": first["losses"],
    "grad1": sorted(first["grad1"]),
    "params": sorted(n for n, _p in prog.state.model.named_parameters()),
    "eval_preds": len(first["eval_rows"]["pred"]),
    "eval_roc": first["eval"][1],
    "records": [sorted(r) for r in runlog.records],
    "nodes": {n: int(sum(g["x"].shape[0] for g in s))
              for n, s in prog.splits.items()},
    "vector_fields": all("edge_eig" in g for s in prog.splits.values()
                         for g in s),
    "dims": ctx["dims"]}))
'''


def copy_of_the_harness(root):
    """``benchmark/`` and ``BENCHMARK.json`` under ``root``, with the
    directional configuration added as new files and entries."""
    bench = os.path.join(root, "benchmark")
    shutil.copytree(HERE, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "cache", "out", "test_*.py"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["configs"].append({
        "name": CONFIG, "file": f"benchmark/configs/{CONFIG}.json",
        "source": "GSN README, ogbg-molhiv DGN (scripts/"
                  "dgn_molhiv_10_runs.py), cut for a test",
        "reduced": ["L", "hidden_dim", "out_dim", "aggregators"],
        "why": "the directional CLI's model through the harness"})
    spec["workloads"].append({
        "name": WORKLOAD, "config": CONFIG, "traffic": "molhiv-epochs",
        "chips": 1, "why": "64 ogb molecules, batch 8"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    with open(os.path.join(bench, "configs", f"{CONFIG}.json"), "w") as f:
        json.dump({"name": CONFIG, "reduced": spec["configs"][-1]["reduced"],
                   "driver": "dgn_cli", "flags": FLAGS,
                   "check": {"limits": {}}}, f)
    for folder, name, body in (("drivers", "dgn_cli", DRIVER),
                               ("work", CONFIG, WORK)):
        with open(os.path.join(bench, folder, f"{name}.py"), "w") as f:
            f.write(body)
    with open(os.path.join(root, "run_dgn.py"), "w") as f:
        f.write(RUN % (WORKLOAD, SIZES))
    return bench


def test_a_directional_model_joins_as_new_files(tmp_path):
    root = str(tmp_path)
    bench = copy_of_the_harness(root)
    env = dict(os.environ, PYTHONHASHSEED="0")
    out = subprocess.run([sys.executable, "run_dgn.py", ROOT], cwd=root,
                         capture_output=True, text=True, timeout=600,
                         env=env)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])

    # set-up and the first steps: three losses, a gradient of every
    # parameter, a prediction of every val molecule
    assert len(res["losses"]) == 3
    assert all(math.isfinite(v) for v in res["losses"])
    assert res["grad1"] == res["params"]
    assert res["eval_preds"] == SIZES["val"]
    assert 0.0 <= res["eval_roc"] <= 1.0
    assert res["vector_fields"] and res["dims"]
    # two epochs, each record with what the core and the metrics read
    assert len(res["records"]) == 2
    for keys in res["records"]:
        for k in ("epoch_s", "eval_s", "steps", "train_loss", "val_loss",
                  "test_loss", "host_batch_s", "step_median_s", "spans",
                  "step_hist", "train.real_edges", "train.edge_slots",
                  "train.captures", "eval.steps", "eval.captures"):
            assert k in keys, k
    m = res["metrics"]
    for name, v in m.items():
        assert v is not None and math.isfinite(v), (name, v)
    assert m["step.window_captures"] == 0            # none on the CPU
    assert 0 < m["batch.edge_fill"] <= 1
    # model.mfu counts forwards of the driver's evaluated splits alone
    n = res["nodes"]
    fwd = {s: 2 * 2 * 8 ** 2 * n[s] for s in n}
    want = 100.0 * (3 * fwd["train"] + fwd["val"] + fwd["test"]) / \
        res["window_s"] / 67.0e12
    assert m["model.mfu"] == pytest.approx(want, rel=1e-9)

    # the harness itself took no edit
    for sub in ("core", "metrics"):
        names = sorted(f for f in os.listdir(os.path.join(HERE, sub))
                       if f.endswith(".py"))
        assert names == sorted(f for f in os.listdir(os.path.join(
            bench, sub)) if f.endswith(".py"))
        for f in names:
            assert filecmp.cmp(os.path.join(HERE, sub, f),
                               os.path.join(bench, sub, f), shallow=False), f
    assert filecmp.cmp(os.path.join(HERE, "reference", "ref_common.py"),
                       os.path.join(bench, "reference", "ref_common.py"),
                       shallow=False)
