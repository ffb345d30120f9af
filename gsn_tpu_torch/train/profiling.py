"""Profiling and roofline numbers (counterpart of
``gsn_tpu/train/profiling.py``).

- ``trace(logdir)``: ``torch.profiler`` around a block (CPU and, where
  there is one, CUDA activity), its trace written under ``logdir`` for
  TensorBoard or Perfetto;
- ``time_fn``: the mean time of a call, by CUDA events on a card and by
  the host clock on the CPU;
- ``flops_of``: the FLOPs ``torch.utils.flop_counter`` counts in one
  call (None where it counts none);
- ``step_stats``: a step's ms, edges/s and, with ``flops_of``, TFLOP/s
  and utilisation of the NVIDIA H100 SXM data-sheet peaks below.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, Optional

import torch

from ..timing import device_sync, fetch_rtt, first_tensor

# NVIDIA H100 SXM data-sheet peaks: f32 (non-tensor-core) and dense bf16
# tensor-core FLOP/s, HBM3 bytes/s
H100_PEAK_F32_TFLOPS = 67.0
H100_PEAK_BF16_DENSE_TFLOPS = 989.0
H100_HBM_GBPS = 3350.0


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with ``torch.profiler``; the Chrome trace goes
    to ``<logdir>/trace.json``.  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _on_cuda(out) -> bool:
    leaf = first_tensor(out)
    return leaf is not None and leaf.is_cuda


def time_fn(fn: Callable, *args, iters: int = 20) -> float:
    """Mean seconds of ``fn(*args)`` over ``iters`` calls after one
    warm-up call: between CUDA events when its output lies on a card,
    else by the host clock less one ``fetch_rtt``."""
    out = fn(*args)
    if _on_cuda(out):
        device_sync(out)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            out = fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    rtt = fetch_rtt(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    device_sync(out)
    return max((time.perf_counter() - t0 - rtt) / iters, 0.0)


def flops_of(fn: Callable, *args) -> Optional[float]:
    """The FLOPs ``FlopCounterMode`` counts in one call of ``fn(*args)``
    (matrix products and convolutions, forward and backward), or None
    when it counts none or is unavailable."""
    try:
        from torch.utils.flop_counter import FlopCounterMode
    except ImportError:
        return None
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args)
    total = counter.get_total_flops()
    return float(total) if total else None


def step_stats(fn: Callable, *args, num_edges: int, iters: int = 20,
               dtype: torch.dtype = torch.float32) -> Dict[str, float]:
    """``step_ms`` and ``edges_per_s`` of one step ``fn(*args)``, and,
    where ``flops_of`` counts its FLOPs, ``tflops`` and its share of the
    H100's peak for ``dtype``: ``util_f32`` (67 TFLOP/s) or
    ``util_bf16_dense`` (989 TFLOP/s)."""
    dt = time_fn(fn, *args, iters=iters)
    stats = {"step_ms": dt * 1e3, "edges_per_s": num_edges / dt}
    fl = flops_of(fn, *args)
    if fl:
        tflops = fl / dt / 1e12
        stats["tflops"] = tflops
        if dtype == torch.bfloat16:
            stats["util_bf16_dense"] = tflops / H100_PEAK_BF16_DENSE_TFLOPS
        else:
            stats["util_f32"] = tflops / H100_PEAK_F32_TFLOPS
    return stats
