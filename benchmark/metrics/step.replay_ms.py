"""The median over the window's epochs of the program's median train
step (``epoch_stats["step_median_s"]``: a replay's CUDA-event time), in
ms.  A per-layer statistic, not an end-to-end rate."""

import statistics


def read(ctx):
    steps = [r["step_median_s"] for r in ctx["records"]
             if r.get("step_median_s")]
    return statistics.median(steps) * 1e3 if steps else None
