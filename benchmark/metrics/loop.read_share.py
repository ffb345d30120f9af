"""The window's host time in the program's reads back from the device
(its ``train.read`` spans, a train run's losses and step times, and
``eval.read``, a split's rows: where the host waits on the device) over
the window's seconds.  None when the program records no spans."""

NAMES = ("train.read", "eval.read")


def read(ctx):
    recs = ctx["records"]
    if not recs or any("spans" not in r for r in recs):
        return None
    waited = sum(r["spans"][n][0] for r in recs for n in NAMES
                 if n in r["spans"])
    return waited / ctx["window_s"]
