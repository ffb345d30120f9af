"""The 99th percentile, in ms, of every timed train step of the window
(a replay's CUDA-event time), from the program's per-epoch
``step_hist`` pooled (log-spaced bins 1% wide).  None when the program
keeps no histogram."""


def read(ctx):
    hists = [r["step_hist"] for r in ctx["records"] if r.get("step_hist")]
    if not hists:
        return None
    from gsn_tpu_torch.spans import hist_quantile
    q = hist_quantile(hists, 0.99)
    return q * 1e3 if q is not None else None
