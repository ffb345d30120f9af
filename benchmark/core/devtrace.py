"""The device trace of the profiled slice, reduced: device intervals,
kernels by name, busy time (their union), the slice's span and the idle
gaps labelled by what the host was doing (the innermost host event open
at the gap's middle)."""

from __future__ import annotations

import bisect
import collections
import time
from typing import Dict, List, Tuple

import torch


def profile_slice(fn) -> Dict:
    """Runs ``fn`` under ``torch.profiler`` (CPU and CUDA activity) and
    returns the reduction below."""
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with record_function("bench.slice"):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return reduce(prof.profiler.kineto_results.events(), wall)


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def reduce(events, wall_s: float) -> Dict:
    device, host = [], []
    for e in events:
        start, dur = e.start_ns(), e.duration_ns()
        if dur <= 0:
            continue
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # kernels, copies and sets; not the device-side spans of
            # host annotations
            if not e.is_user_annotation():
                device.append((e.name(), start, start + dur))
        else:
            host.append((start, start + dur, e.name()))
    busy = _union([(a, b) for _n, a, b in device])
    by_name = collections.Counter()
    for name, a, b in device:
        by_name[name] += (b - a) * 1e-9
    spans = sorted(host)
    starts = [s for s, _e, _n in spans]
    gaps = collections.Counter()
    for (_a, end), (nxt, _b) in zip(busy, busy[1:]):
        mid = (end + nxt) // 2
        label = "python (no traced op)"
        # the latest-starting host event still open at mid is innermost
        i = bisect.bisect_right(starts, mid) - 1
        for s, e, n in reversed(spans[max(0, i - 4096):i + 1]):
            if e >= mid:
                label = n
                break
        gaps[label] += (nxt - end) * 1e-9
    return {"wall_s": wall_s,
            "busy_s": sum(b - a for a, b in busy) * 1e-9,
            "kernels": dict(by_name),
            "gaps": dict(gaps)}


def breakdown(red: Dict) -> Dict:
    top = sorted(red["kernels"].items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(red["gaps"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in gaps]}
