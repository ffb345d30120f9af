"""The port's kernels' (K1-K6, by name) device time over all of the
device's busy time in the profiled slice."""

import registry


def read(ctx):
    t = ctx["trace"]
    roof = registry.module("metrics", "kernels_roofline")
    return roof.port_time(t["kernels"]) / t["busy_s"] \
        if t["busy_s"] > 0 else None
