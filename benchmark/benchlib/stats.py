"""
The arithmetic of the benchmark's numbers: rates over a whole window,
percentiles of all requests, the spread of repeated runs, and the device's
busy time as the union of its intervals.
"""

from __future__ import annotations

import math
import statistics
from typing import Iterable, List, Sequence, Tuple


def rate(ops: float, window_s: float) -> float:
    """Operations answered in the window over the window's whole length."""
    if window_s <= 0:
        raise ValueError("empty window")
    return ops / window_s


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile of every value, linearly interpolated between
    order statistics (numpy's default)."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    r = q / 100.0 * (len(v) - 1)
    lo, hi = math.floor(r), math.ceil(r)
    return v[lo] + (r - lo) * (v[hi] - v[lo])


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartiles, as Python's
    statistics.quantiles(values, n=4) gives them, over the median."""
    q1, _q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merged, sorted, non-overlapping intervals."""
    out: List[Tuple[float, float]] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def clip(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi]


def busy(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> float:
    """Length of the union of the intervals inside [lo, hi]."""
    return sum(b - a for a, b in union(clip(intervals, lo, hi)))


def gaps(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The idle stretches of [lo, hi] that no interval covers."""
    out, cur = [], lo
    for a, b in union(clip(intervals, lo, hi)):
        if a > cur:
            out.append((cur, a))
        cur = max(cur, b)
    if hi > cur:
        out.append((cur, hi))
    return out


def idle_share(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> float:
    """Per cent of [lo, hi] in which the device ran nothing."""
    return 100.0 * (1.0 - busy(intervals, lo, hi) / (hi - lo))
