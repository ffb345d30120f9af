"""The window's wall seconds over the whole ``fit`` epochs it ran."""


def read(ctx):
    return ctx["window_s"] / len(ctx["records"])
