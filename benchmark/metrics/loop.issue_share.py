"""The window's host time spent issuing steps (the self time of the
program's ``train.load``, ``train.launch``, ``eval.load`` and
``eval.launch`` spans: loading a step graph's static buffers and
launching its replay, or the eager step) over the window's seconds.
None when the program records no spans."""

NAMES = ("train.load", "train.launch", "eval.load", "eval.launch")


def read(ctx):
    recs = ctx["records"]
    if not recs or any("spans" not in r for r in recs):
        return None
    issued = sum(r["spans"][n][1] for r in recs for n in NAMES
                 if n in r["spans"])
    return issued / ctx["window_s"]
