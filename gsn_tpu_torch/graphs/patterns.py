"""Substructure (pattern) vocabulary generators.

A copy of the part of ``gsn_tpu/graphs/patterns.py`` that the port's
data path uses.  A pattern is a plain ``list[tuple[int, int]]`` of
undirected edges over vertices ``0..n-1``.
"""

from __future__ import annotations

from typing import List, Tuple

Edge = Tuple[int, int]
EdgeList = List[Edge]


def cycle_graph(k: int) -> EdgeList:
    """Cycle on k vertices (k >= 3)."""
    if k < 3:
        raise ValueError("cycle_graph requires k >= 3")
    return [(i, (i + 1) % k) for i in range(k)]
