"""The window's train steps whose batch the host built and copied after
an earlier replay of its epoch had been launched (the program's counter
``train.overlapped_batches``) over all its train steps (``steps``): how
much of the host's batching runs while the card runs replays.  None
when the program counts no such steps."""


def read(ctx):
    recs = ctx["records"]
    if not recs or any("train.overlapped_batches" not in r for r in recs):
        return None
    steps = sum(r["steps"] for r in recs)
    return (sum(r["train.overlapped_batches"] for r in recs) / steps
            if steps else None)
