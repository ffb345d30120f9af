"""The window's real edges over the edge slots its train steps carried
(the program's row counters ``train.real_edges`` / ``train.edge_slots``
of each epoch, counted on the host as the batches are built): how much
of the fixed edge caps is padding.  None when the program counts no
rows."""


def read(ctx):
    recs = ctx["records"]
    if not recs or any("train.edge_slots" not in r for r in recs):
        return None
    slots = sum(r["train.edge_slots"] for r in recs)
    return sum(r["train.real_edges"] for r in recs) / slots if slots else None
