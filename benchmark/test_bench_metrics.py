"""The per-layer metrics that read the program's spans and counters, on
hand-built contexts: each reads its known value, and none when the
program recorded nothing (as a program without the recorder)."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), os.path.join(HERE, "core")]

import registry  # noqa: E402
from gsn_tpu_torch import spans  # noqa: E402


def record(real, slots, load, launch, read, eval_read, hist, captures):
    """One epoch's record: spans {name: [seconds, self seconds, closed]},
    counters and a step histogram as ``log.jsonl`` gives them back."""
    return {"train.real_edges": real, "train.edge_slots": slots,
            "train.captures": captures[0], "eval.captures": captures[1],
            "step_hist": {str(k): n for k, n in hist.items()},
            "spans": {"train.load": [load + 1.0, load, 10],
                      "train.launch": [launch, launch, 10],
                      "eval.launch": [0.5, 0.25, 4],
                      "train.read": [read, read, 1],
                      "eval.read": [eval_read, eval_read, 3],
                      "train.epoch": [9.0, 0.1, 1]}}


def bin_of(seconds):
    h = {}
    spans.hist_add(h, seconds)
    return next(iter(h))


@pytest.fixture
def ctx():
    fast, slow = bin_of(4.4e-3), bin_of(6e-3)
    recs = [record(6000, 13000, 0.5, 2.0, 1.0, 0.25, {fast: 99}, (0, 0)),
            record(7000, 13000, 0.25, 1.0, 0.5, 0.25, {fast: 100, slow: 1},
                   (1, 2))]
    return {"records": recs, "window_s": 20.0}


def read(name, ctx):
    return registry.module("metrics", name).read(ctx)


def test_window_metrics(ctx):
    assert read("batch.edge_fill", ctx) == pytest.approx(13000 / 26000)
    # self times: train.load 0.75, train.launch 3.0, eval.launch 0.5
    assert read("loop.issue_share", ctx) == pytest.approx(4.25 / 20.0)
    assert read("loop.read_share", ctx) == pytest.approx(2.0 / 20.0)
    assert read("step.window_captures", ctx) == 3
    # 200 steps: the 198th is the fast bin's last
    assert read("step.replay_p99_ms", ctx) == pytest.approx(4.4, rel=0.006)
    ctx["records"][1]["step_hist"][str(bin_of(6e-3))] = 3
    assert read("step.replay_p99_ms", ctx) == pytest.approx(6.0, rel=0.006)


@pytest.mark.parametrize("name", ["batch.edge_fill", "loop.issue_share",
                                  "loop.read_share", "step.window_captures",
                                  "step.replay_p99_ms"])
def test_window_metrics_without_their_keys(ctx, name):
    """A record from a program without spans and counters (the old keys
    only) reads as nothing, as an empty window does."""
    old = {"epoch_s": 1.0, "eval_s": 0.1, "host_batch_s": 0.2,
           "step_median_s": 0.004, "capture_s": 0.0, "steps": 10}
    assert read(name, {"records": [old, old], "window_s": 20.0}) is None
    assert read(name, {"records": [], "window_s": 20.0}) is None


@pytest.mark.parametrize("name,span", [("model.init_s", "model.init"),
                                       ("data.count_s", "data.count")])
def test_setup_metrics(monkeypatch, name, span):
    """The process's total of the set-up span, or nothing without it."""
    monkeypatch.setattr(spans, "_totals", {})
    assert read(name, {}) is None
    monkeypatch.setattr(spans, "_totals", {span: [int(9.5e9), 0, 1],
                                           "other": [1, 1, 1]})
    assert read(name, {}) == pytest.approx(9.5)
