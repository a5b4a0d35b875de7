"""The arithmetic the benchmark reduces its samples with."""

from __future__ import annotations

import math
import statistics
from typing import Iterable, List, Sequence, Tuple

__all__ = ["percentile", "quartile_spread", "trimmed_spread", "union_seconds", "idle_gaps"]


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile of every value: the smallest
    value with at least ``q`` percent of the values at or below it."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def quartile_spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartiles over the median, as
    ``statistics.quantiles(values, n=4)`` places them."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def trimmed_spread(values: Sequence[float]) -> float:
    """:func:`quartile_spread` of the values less the one farthest from
    their median: how a bound's tightness is judged, so that one far-off
    run in a set does no harm."""
    mid = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - mid))
    return quartile_spread([v for i, v in enumerate(values) if i != far])


def _merged(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The intervals clipped to ``[lo, hi]``, sorted and merged."""
    clipped = sorted((max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi)
    out: List[List[float]] = []
    for a, b in clipped:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def union_seconds(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> float:
    """Length of the union of the intervals inside ``[lo, hi]``: the time
    in which at least one of them was running."""
    return sum(b - a for a, b in _merged(intervals, lo, hi))


def idle_gaps(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The stretches of ``[lo, hi]`` that no interval covers."""
    gaps, t = [], lo
    for a, b in _merged(intervals, lo, hi):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    return gaps
