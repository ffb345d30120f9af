"""The window's host batching and copying (the sum of the program's
``epoch_stats["host_batch_s"]`` over its epochs) over the window's
seconds."""


def read(ctx):
    return sum(r["host_batch_s"] for r in ctx["records"]) / ctx["window_s"]
