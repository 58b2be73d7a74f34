"""Rates and the union of intervals: the arithmetic the metrics share."""
from __future__ import annotations

from typing import Iterable, List, Tuple


def rate(amount: float, window_s: float) -> float:
    """Work over the whole window, idle time included."""
    if window_s <= 0:
        raise ValueError("empty window")
    return amount / window_s


def union_length(spans: Iterable[Tuple[float, float]]) -> float:
    """Length covered by the union of the intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def gaps(spans: Iterable[Tuple[float, float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out: List[Tuple[float, float]] = []
    cur = lo
    for s, e in sorted(spans):
        if e <= cur:
            continue
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]
