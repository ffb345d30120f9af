"""Seconds of the program's ``Trainer.init_state`` in set-up (its
``model.init`` span, the process's total: the model's build, its
weight draws, the move to the device and the optimizer).  None when
the program records no such span."""


def read(ctx):
    try:
        from gsn_tpu_torch import spans
    except ImportError:        # a program without the span recorder
        return None
    t = spans.totals().get("model.init")
    return t[0] if t else None
