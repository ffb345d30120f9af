"""The program's ``epoch_stats["capture_s"]`` of its first train epoch:
the eager first step and the capture of the train step's CUDA graph."""


def read(ctx):
    return ctx["capture_s"]
