"""Seconds of the program's data path in set-up (substructure counting
and id encoding of every molecule), on the harness's clock."""


def read(ctx):
    return ctx["prepare_s"]
