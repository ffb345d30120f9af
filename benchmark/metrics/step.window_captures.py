"""Step graphs captured inside the window (the program's counters
``train.captures`` and ``eval.captures`` of its epochs): 0 once the
warm-up has captured every shape.  None when the program counts no
captures."""


def read(ctx):
    recs = ctx["records"]
    if not recs or any("eval.captures" not in r for r in recs):
        return None
    return sum(r["train.captures"] + r["eval.captures"] for r in recs)
