"""The check against its faults: a run on the CPU at a small size (the
look for a chip skipped), with the timed path broken underneath, has to
come out not correct; and, on the card, the control (the reference in
TF32 in the program's place) has to fail the cell's limits."""

import os
import sys
import time

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), os.path.join(HERE, "core")]

import cell  # noqa: E402
import compare  # noqa: E402
import registry  # noqa: E402
from faults import FAULTS  # noqa: E402

SIZES = {"zinc-gsn-ef-500k.fit": {"train": 400, "val": 128, "test": 32},
         "molhiv-gsn-vn-af.fit": {"train": 128, "val": 128, "test": 32}}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", sorted(SIZES))
def test_a_broken_step_is_not_correct(workload, fault):
    out = cell.run(workload, 12345, 0.1, False, "cpu", time.perf_counter(),
                   sizes=SIZES[workload], fault=FAULTS[fault])
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(SIZES))
def test_the_control_is_not_correct(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    import readings
    out = readings.seed_readings(workload, 99, "cuda", SIZES[workload],
                                 faults={})
    _w, config, _t = registry.cell(workload)
    _checks, ok = compare.judge(out["control_tf32"],
                                config["check"]["limits"])
    assert not ok
