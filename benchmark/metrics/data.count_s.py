"""Seconds of the program's substructure counting in set-up (its
``data.count`` span around ``generate_dataset``, the process's total):
the part of ``data.prepare_s`` the program times itself.  None when
the program records no such span."""


def read(ctx):
    try:
        from gsn_tpu_torch import spans
    except ImportError:        # a program without the span recorder
        return None
    t = spans.totals().get("data.count")
    return t[0] if t else None
