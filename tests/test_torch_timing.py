"""The port's timing and profiling helpers on the CPU
(``gsn_tpu_torch.timing``, ``gsn_tpu_torch.train.profiling``), mirroring
tests/test_timing.py's four cases: the barrier returns its input, takes
0-d and n-d tensors, numpy arrays and empty trees, and ``fetch_rtt`` is
a real (nonnegative, repeatable) measurement; then ``step_stats``'s
keys and ``trace``'s file."""

import os

import numpy as np
import torch

from gsn_tpu_torch.timing import device_sync, fetch_rtt
from gsn_tpu_torch.train import profiling


def test_device_sync_returns_0d_leaf_unchanged():
    x = torch.tensor(3.0) * 2.0
    assert device_sync(x) is x
    assert device_sync(device_sync(x)) is x
    assert float(x) == 6.0


def test_device_sync_returns_nd_leaf_unchanged():
    x = torch.arange(8.0) + 1.0
    assert device_sync(x) is x
    torch.testing.assert_close(x, torch.arange(8.0) + 1.0)


def test_fetch_rtt_repeatable_on_0d():
    x = torch.tensor(1.5) + 0.5
    r1 = fetch_rtt(x)
    r2 = fetch_rtt(x)
    assert r1 >= 0.0 and r2 >= 0.0
    assert r1 < 1.0 and r2 < 1.0


def test_device_sync_returns_input_and_handles_numpy():
    tree = {"a": np.zeros(3), "b": torch.ones(2, 2)}
    out = device_sync(tree)
    assert out is tree
    assert device_sync({}) == {}
    assert device_sync([np.ones(2), (torch.zeros(1),)])[0].shape == (2,)


def test_step_stats_keys_on_the_cpu():
    a = torch.randn(32, 32)
    f32 = profiling.step_stats(lambda x: x @ x, a, num_edges=100, iters=3)
    assert set(f32) == {"step_ms", "edges_per_s", "tflops", "util_f32"}
    assert f32["step_ms"] >= 0.0 and f32["tflops"] >= 0.0
    assert profiling.flops_of(lambda x: x @ x, a) == 2 * 32 ** 3
    bf = profiling.step_stats(lambda x: x @ x, a.bfloat16(), num_edges=100,
                              iters=3, dtype=torch.bfloat16)
    assert "util_bf16_dense" in bf and "util_f32" not in bf
    # no matrix product: no FLOPs counted, no TFLOP/s
    plain = profiling.step_stats(lambda x: x + 1, a, num_edges=5, iters=2)
    assert set(plain) == {"step_ms", "edges_per_s"}


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        torch.randn(16, 16) @ torch.randn(16, 16)
    assert prof is not None
    assert os.path.getsize(tmp_path / "trace.json") > 0
