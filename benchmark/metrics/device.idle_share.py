"""1 - the union of the device's kernel and copy intervals over the
profiled slice's wall time."""


def read(ctx):
    t = ctx["trace"]
    return 1.0 - t["busy_s"] / t["wall_s"]
