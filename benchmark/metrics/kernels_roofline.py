"""The port's kernels in the profiled slice against their roofline, in
%: the least time of the functions they compute in the slice (the
configuration's ``kernel_work`` over the slice's train and eval
subsets, each function at the larger of its bytes at the bandwidth and
its operations at the f32 peak) over the device time of the port's
kernels (K1-K6, by name).  None when the slice ran none of them."""

import math

import registry

PORT_KERNELS = ("edge_message_", "segment_sum_", "segment_broadcast",
                "dgn_aggregate_")


def port_time(kernels):
    return sum(s for n, s in kernels.items()
               if any(k in n for k in PORT_KERNELS))


def read(ctx):
    peaks = registry.module("work", "peaks")
    work, flags = ctx["work"], ctx["config"]["flags"]
    b = ctx["hyper"]["batch_size"]
    least = 0.0
    for part, train in (("train", True), ("eval", False)):
        graphs = ctx["slice"][part]
        for _f, flops, nbytes in work.kernel_work(
                flags, graphs, math.ceil(len(graphs) / b), train):
            least += peaks.least_s(flops, nbytes)
    spent = port_time(ctx["trace"]["kernels"])
    return 100.0 * least / spent if spent > 0 else None
