"""CLI argument-type parsers (reference ``utils_parsing.py``; a copy of
``gsn_tpu/parsing.py``)."""

from __future__ import annotations


def str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise ValueError(f"boolean value expected, got {v!r}")


def str2list2int(v):
    if v is None or v == "None":
        return None
    return [int(x) for x in str(v).split(",")]


def str2list2bool(v):
    if v is None or v == "None":
        return None
    return [str2bool(x) for x in str(v).split(",")]


def str2list2float(v):
    """Reference ``utils_parsing.py:24-25``."""
    if v is None or v == "None":
        return None
    return [float(x) for x in str(v).split(",")]


def str2ListOfLists2int(v):
    """',' separates ints within a list, ',,' separates lists
    (reference ``utils_parsing.py:16-17``)."""
    if v is None or v == "None":
        return None
    return [[int(x) for x in li.split(",")] for li in str(v).split(",,")]


def str2ListOfListsOfLists2int(v):
    """Custom edge-list grammar: ',' separates ints within an edge, ',,'
    separates edges, ',,,' separates substructures (reference
    utils_parsing.py str2ListOfListsOfLists2int)."""
    if v is None or v == "None":
        return None
    out = []
    for sub in str(v).split(",,,"):
        edges = []
        for edge in sub.split(",,"):
            edges.append(tuple(int(x) for x in edge.split(",")))
        out.append(edges)
    return out
