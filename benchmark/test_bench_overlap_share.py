"""``loop.overlap_share`` on hand-built contexts: the window's steps fed
after a replay (the program's counter ``train.overlapped_batches``)
over its steps, and nothing when the records lack the counter (a
program that does not count it) or the window is empty."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), os.path.join(HERE, "core")]

import registry  # noqa: E402


def read(ctx):
    return registry.module("metrics", "loop.overlap_share").read(ctx)


def record(steps, overlapped):
    """One epoch's record as ``log.jsonl`` gives it back."""
    return {"epoch_s": 0.5, "eval_s": 0.1, "steps": steps,
            "train.runs": 1, "train.overlapped_batches": overlapped}


def test_reads_the_counter_over_the_steps():
    recs = [record(79, 78), record(79, 78), record(79, 77)]
    assert read({"records": recs, "window_s": 2.0}) == pytest.approx(
        233 / 237)
    assert read({"records": [record(16, 0)], "window_s": 1.0}) == 0.0


@pytest.mark.parametrize("recs", [
    [],
    [{"epoch_s": 0.5, "steps": 79, "train.runs": 1}] * 2,
    [record(79, 78), {"epoch_s": 0.5, "steps": 79, "train.runs": 1}],
    [record(0, 0)],
], ids=["empty", "no_counter", "one_without", "no_steps"])
def test_nothing_without_the_counter(recs):
    assert read({"records": recs, "window_s": 2.0}) is None
