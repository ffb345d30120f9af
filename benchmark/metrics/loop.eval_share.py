"""The window's evaluations (the sum of ``fit``'s ``eval_s`` over its
epochs: train, test and val splits) over the window's seconds."""


def read(ctx):
    return sum(r["eval_s"] for r in ctx["records"]) / ctx["window_s"]
