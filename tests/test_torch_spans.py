"""The port's spans and counters (``gsn_tpu_torch/spans.py``) on the CPU:
how the epoch loop's spans nest on the per-step and the graphed paths,
self times, the ``epoch_stats`` and ``fit`` record keys computed from
them, the row counters against each batch's masks, the step histogram's
quantiles, the profiler ranges (none without a profiler; under
``torch.profiler`` the spans enclose their aten ops) and ``fit``'s record
through ``RunLogger``'s ``log.jsonl``."""

import json
import math
import statistics
import time

import numpy as np
import pytest
import torch

from gsn_tpu_torch import spans
from gsn_tpu_torch.config import GSNConfig
from gsn_tpu_torch.data.synthetic import make_molhiv_like, make_zinc_like
from gsn_tpu_torch.train import loop
from gsn_tpu_torch.train.graphs import batch_sig, runs
from gsn_tpu_torch.train.logging import RunLogger

# each span of a fit epoch and its parent
PARENT = {"train.epoch": "fit.epoch", "eval": "fit.epoch",
          "fit.checkpoint": "fit.epoch",
          "train.batch": "train.epoch", "train.copy": "train.epoch",
          "train.load": "train.epoch", "train.launch": "train.epoch",
          "train.read": "train.epoch", "train.plan": "train.epoch",
          "eval.plan": "eval", "eval.load": "eval", "eval.launch": "eval",
          "eval.read": "eval", "eval.unpack": "eval", "eval.metric": "eval"}


def zinc_cfg(d_id):
    return GSNConfig(
        model_name="GSN_edge_sparse", num_layers=2, d_out=16,
        out_features=1, msg_kind="general", id_scope="global",
        id_embedding="one_hot_encoder", input_node_encoder="embedding",
        edge_encoder="embedding", readout="sum", in_features=1,
        d_in_node_encoder=[28], d_in_edge_encoder=[4], d_in_id=d_id)


def molhiv_cfg(d_id):
    return GSNConfig(
        model_name="GSN_edge_sparse_ogb", num_layers=2, d_out=16, d_h=32,
        out_features=1, msg_kind="ogb", id_scope="local", vn=True,
        dropout_features=0.5, readout="mean", final_projection=[False],
        jk_mlp=False, id_embedding="embedding", d_out_id_embedding=16,
        input_node_encoder="atom_encoder", edge_encoder="bond_encoder",
        input_vn_encoder="embedding", in_features=9, in_edge_features=3,
        d_in_id=d_id)


@pytest.fixture(scope="module")
def data():
    return {"zinc": make_zinc_like(46, seed=3),
            "molhiv": make_molhiv_like(46, seed=4)}


def make_trainer(data, kind, scan, **over):
    graphs, d_id = data[kind]
    if kind == "zinc":
        cfg = zinc_cfg(d_id)
        kw = dict(loss_fn="L1Loss", prediction_fn="L1Loss")
    else:
        cfg = molhiv_cfg(d_id)
        kw = dict(loss_fn="BCEWithLogitsLoss", prediction_fn="None",
                  evaluator="rocauc")
    kw.update(over)
    tcfg = loop.TrainerConfig(lr=1e-3, batch_size=8, scheduler="None",
                              seed=2, num_epochs=2, scan_epochs=scan, **kw)
    train = graphs[:22]
    trainer = loop.Trainer(cfg, tcfg, train, device="cpu")
    return trainer, trainer.init_state(seed=0), graphs


def fit(trainer, state, graphs, tmp_path):
    """Two fit epochs into a RunLogger: (state, the log's records)."""
    logger = RunLogger(run_dir=str(tmp_path / "run"))
    state, _hist = trainer.fit(state, graphs[:22], graphs[22:34],
                               graphs_val=graphs[34:],
                               checkpoint_file=str(tmp_path / "ck.pt"),
                               log_fn=None, logger=logger)
    logger.close()
    lines = (tmp_path / "run" / "log.jsonl").read_text().splitlines()
    return state, [json.loads(li) for li in lines if '"step"' in li]


@pytest.mark.parametrize("kind", ["zinc", "molhiv"])
@pytest.mark.parametrize("scan", [True, False], ids=["graphed", "per_step"])
def test_spans_nest(data, tmp_path, kind, scan):
    """Every span of a fit epoch has the parent the contract names, lies
    inside it in time, and the path's per-step spans are there."""
    trainer, state, graphs = make_trainer(data, kind, scan)
    spans.recent.clear()
    fit(trainer, state, graphs, tmp_path)
    got = list(spans.recent)
    names = {n for n, *_ in got}
    open_at = {}
    for name, start, end, parent in got:
        assert start <= end
        if name == "fit.epoch":
            assert parent is None
        else:
            assert parent == PARENT[name], (name, parent)
        open_at.setdefault(name, []).append((start, end))
    for name, start, end, parent in got:
        if parent is not None:
            assert any(a <= start and end <= b for a, b in open_at[parent])
    want = {"fit.epoch", "train.epoch", "eval", "fit.checkpoint",
            "train.batch", "train.copy", "train.launch", "train.read",
            "eval.plan", "eval.launch", "eval.read"}
    if scan:
        want |= {"train.plan", "train.load", "eval.load", "eval.unpack"}
    if kind == "molhiv":
        want.add("eval.metric")
    assert want <= names
    assert "train.capture" not in names and "eval.capture" not in names
    if not scan:
        assert not names & {"train.plan", "train.load", "eval.load",
                            "eval.unpack"}


def test_self_time_is_duration_less_children():
    """A span's self time is its duration less the spans directly
    inside it (theirs counted once, not their children's again)."""
    snap = spans.snapshot()
    with spans.span("t.outer") as outer:
        with spans.span("t.a"):
            time.sleep(0.002)
        with spans.span("t.b"):
            with spans.span("t.c"):
                time.sleep(0.002)
            time.sleep(0.001)
        time.sleep(0.001)
    got, _counts = spans.since(snap)
    assert got["t.outer"][0] == pytest.approx(outer.seconds, abs=1e-12)
    assert got["t.outer"][1] == pytest.approx(
        got["t.outer"][0] - got["t.a"][0] - got["t.b"][0], abs=1e-12)
    assert got["t.b"][1] == pytest.approx(got["t.b"][0] - got["t.c"][0],
                                          abs=1e-12)
    assert got["t.a"][1] == got["t.a"][0]
    assert got["t.outer"][1] >= 0.0009
    assert [got[n][2] for n in ("t.outer", "t.a", "t.b", "t.c")] == [1] * 4
    whole = spans.totals()
    assert whole["t.c"][2] >= 1


@pytest.mark.parametrize("scan", [True, False], ids=["graphed", "per_step"])
def test_fit_record_self_times(data, tmp_path, scan):
    """In fit's record, ``fit.epoch`` and ``train.epoch``'s self times are
    their totals less their children's."""
    trainer, state, graphs = make_trainer(data, "zinc", scan)
    _state, recs = fit(trainer, state, graphs, tmp_path)
    assert len(recs) == 2
    for r in recs:
        s = r["spans"]
        kids = {p: [n for n, q in PARENT.items() if q == p and n in s]
                for p in ("fit.epoch", "train.epoch")}
        for p, names in kids.items():
            assert s[p][1] == pytest.approx(
                s[p][0] - sum(s[n][0] for n in names), abs=1e-9)
            assert 0 <= s[p][1] <= s[p][0]
        assert s["fit.epoch"][2] == s["train.epoch"][2] == 1


@pytest.mark.parametrize("scan", [True, False], ids=["graphed", "per_step"])
def test_epoch_keys_keep_their_meaning(data, tmp_path, scan):
    """``epoch_s``, ``host_batch_s``, ``capture_s``, ``steps``,
    ``step_median_s`` and ``eval_s`` from the spans: ``host_batch_s`` is
    exactly ``train.batch`` + ``train.copy`` of the same epoch, and the
    median is the steps' own."""
    trainer, state, graphs = make_trainer(data, "molhiv", scan)
    spans.recent.clear()
    state, _loss = trainer.train_epoch(state, graphs[:22])
    st = trainer.epoch_stats
    s = st["spans"]
    assert st["epoch_s"] == s["train.epoch"][0]
    assert st["host_batch_s"] == s["train.batch"][0] + s["train.copy"][0]
    assert st["capture_s"] == 0.0 and "train.capture" not in s
    assert st["steps"] == 3 == s["train.launch"][2]
    sec = {}
    for name, a, b, _p in spans.recent:
        sec.setdefault(name, []).append((b - a) * 1e-9)
    if scan:
        steps = sec["train.launch"]
        assert s["train.load"][2] == 3 and s["train.read"][2] == 1
    else:
        steps = [a + b for a, b in zip(sec["train.launch"],
                                       sec["train.read"])]
        assert s["train.copy"][2] == s["train.read"][2] == 3
    assert st["step_median_s"] == statistics.median(steps)
    assert sum(st["step_hist"].values()) == 3
    _state, recs = fit(trainer, state, graphs, tmp_path)
    r = recs[-1]
    assert r["eval_s"] == r["spans"]["eval"][0]
    for k in ("epoch_s", "host_batch_s", "steps", "step_median_s",
              "capture_s", "step_hist"):
        assert r[k] == json.loads(json.dumps(trainer.epoch_stats[k])), k


@pytest.mark.parametrize("num_iters", [None, 7], ids=["epoch", "wrapped"])
@pytest.mark.parametrize("scan", [True, False], ids=["graphed", "per_step"])
def test_row_counters_match_masks(data, scan, num_iters):
    """The row counters of an epoch equal the totals of its steps'
    batches' masks (a wrapped step counted again), and ``train.runs``
    the runs of their signatures."""
    trainer, state, graphs = make_trainer(data, "zinc", scan,
                                          num_iters=num_iters)
    kept = []
    build = trainer._train_batches

    def keep(gs):
        out = build(gs)
        kept.extend(out)
        return out

    trainer._train_batches = keep
    trainer.train_epoch(state, graphs[:22])
    n = num_iters or len(kept)
    seq = [kept[k % len(kept)] for k in range(n)]
    st = trainer.epoch_stats
    want = {"train.real_nodes": sum(int(b.node_mask.sum()) for b in seq),
            "train.node_slots": sum(b.node_mask.size for b in seq),
            "train.real_edges": sum(int(b.edge_mask.sum()) for b in seq),
            "train.edge_slots": sum(b.edge_mask.size for b in seq),
            "train.real_graphs": sum(int(b.graph_mask.sum()) for b in seq),
            "train.graph_slots": sum(b.graph_mask.size for b in seq)}
    assert {k: st[k] for k in want} == want
    assert want["train.real_edges"] < want["train.edge_slots"]
    runs_n = len(list(runs([batch_sig(b) for b in seq]))) if scan else 0
    assert st["train.runs"] == runs_n
    assert st["train.captures"] == 0 and st["graphs.evicted"] == 0


def test_graphs_evicted_counted(data):
    """A graph dropped past ``MAX_GRAPHS`` is counted: with room for one,
    the eval graph drops the train graph and the next epoch's train
    graph drops it."""
    trainer, state, graphs = make_trainer(data, "zinc", True)
    trainer.MAX_GRAPHS = 1
    state, _ = trainer.train_epoch(state, graphs[:22])
    assert trainer.epoch_stats["graphs.evicted"] == 0
    snap = spans.snapshot()
    trainer.evaluate(state, graphs[22:])
    # each of the 3 eval steps gathers per edge at both ends in 2 layers
    # (f32 bn_mlp messages), on the segment route
    assert spans.since(snap)[1] == {"graphs.evicted": 1, "eval.steps": 3,
                                    "edge_gather.segment": 3 * 2 * 2}
    trainer.train_epoch(state, graphs[:22])
    assert trainer.epoch_stats["graphs.evicted"] == 1


def test_step_hist_quantiles():
    """The pooled histogram's median and p99 lie within 1% of the exact
    nearest-rank ones; JSON's string keys pool with int keys."""
    rng = np.random.RandomState(0)
    xs = list(np.exp(rng.normal(np.log(4.4e-3), 0.2, 3000)))
    a, b = {}, {}
    for i, x in enumerate(xs):
        spans.hist_add(a if i % 2 else b, x)
    b = json.loads(json.dumps(b))
    assert sum(a.values()) + sum(b.values()) == len(xs)
    exact = sorted(xs)
    for q in (0.5, 0.99):
        want = exact[math.ceil(q * len(xs)) - 1]
        assert spans.hist_quantile([a, b], q) == pytest.approx(want,
                                                               rel=0.01)
    assert spans.hist_quantile([a, b], 0.5) == pytest.approx(
        statistics.median(xs), rel=0.01)
    assert spans.hist_quantile([{}], 0.99) is None


def test_no_profiler_no_record_function(data, monkeypatch):
    """Without a profiler the spans make no ``record_function`` call;
    under one they do."""
    calls = []
    real = torch.autograd.profiler.record_function

    def counting(name, *a, **k):
        calls.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        counting)
    trainer, state, graphs = make_trainer(data, "zinc", True)
    state, _ = trainer.train_epoch(state, graphs[:22])
    trainer.evaluate(state, graphs[22:])
    ours = set(PARENT) | {"fit.epoch"}
    assert [c for c in calls if c in ours] == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        trainer.train_epoch(state, graphs[:22])
    assert {"train.launch", "train.epoch"} <= set(calls)


@pytest.mark.parametrize("scan", [True, False], ids=["graphed", "per_step"])
def test_profiler_ranges_enclose_their_ops(data, scan):
    """Under ``torch.profiler`` on the CPU, ``train.launch`` and
    ``eval.read`` are host events holding aten ops."""
    trainer, state, graphs = make_trainer(data, "zinc", scan)
    state, _ = trainer.train_epoch(state, graphs[:22])
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        trainer.train_epoch(state, graphs[:22])
        trainer.evaluate(state, graphs[22:])
    events = prof.events()
    for name in ("train.launch", "eval.read"):
        ours = [e for e in events if e.name == name]
        assert ours, name
        assert any(c.name.startswith("aten::")
                   for e in ours for c in e.cpu_children), name


def test_fit_record_through_run_logger(data, tmp_path):
    """``fit``'s record, spans, counters and histogram included, is one
    JSON line of ``log.jsonl``; the eval counters count every split's
    steps."""
    trainer, state, graphs = make_trainer(data, "molhiv", True)
    _state, recs = fit(trainer, state, graphs, tmp_path)
    assert [r["step"] for r in recs] == [0, 1]
    per_eval = sum(math.ceil(n / 8) for n in (22, 12, 12))
    for r in recs:
        assert r["eval.steps"] == per_eval and r["eval.captures"] == 0
        assert set(loop.FIT_COUNTS) <= set(r)
        assert all(int(k) < 0 for k in r["step_hist"])   # under a second
        assert r["spans"]["eval.launch"][2] == per_eval
        assert r["spans"]["fit.checkpoint"][2] == 1
        assert {"train_loss", "val_loss", "eval_s", "epoch_s"} <= set(r)


def test_setup_spans():
    """Counting, encoding and the model's set-up are spans of their own,
    outside any epoch."""
    spans.recent.clear()
    snap = spans.snapshot()
    graphs, d_id = make_zinc_like(6, seed=1)
    trainer = loop.Trainer(zinc_cfg(d_id), loop.TrainerConfig(batch_size=4),
                           graphs, device="cpu")
    trainer.init_state(seed=0)
    got, _ = spans.since(snap)
    for name in ("data.count", "data.encode", "model.init"):
        assert got[name][2] == 1
        assert spans.totals()[name][0] >= got[name][0]
    assert all(p is None for n, _a, _b, p in spans.recent
               if n in ("data.count", "data.encode", "model.init"))
