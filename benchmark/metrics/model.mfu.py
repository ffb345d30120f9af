"""The window's model FLOPs (the configuration's ``model_flops``: a train
epoch of the train split, then a forward of each split an epoch
evaluates, the driver's ``EVAL_SPLITS``) over the window's seconds, as
a share of the H100's f32 peak (TF32 is off), in %."""

import registry


def read(ctx):
    peaks = registry.module("work", "peaks")
    work, flags = ctx["work"], ctx["config"]["flags"]
    s, dims = ctx["splits"], ctx["dims"]
    per_epoch = work.model_flops(flags, dims, s["train"], True) + sum(
        work.model_flops(flags, dims, s[n], False) for n in s
        if n in ctx["eval_splits"])
    flops = per_epoch * len(ctx["records"])
    return 100.0 * flops / ctx["window_s"] / peaks.F32_FLOPS
