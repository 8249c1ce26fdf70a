"""
Readers of what the program itself puts in the trace: the engine step's
block markers (`aa_mark_<block>` kernels, audio_analysis_tpu_torch/ops/
marker.py) and its named host spans (`aa.*`, audio_analysis_tpu_torch/
utils/timing.py). A trace of a program without them (an older commit)
reads None here, and the metric is left out of the result line.
"""

from __future__ import annotations

import bisect
from typing import List, Tuple

from benchlib import stats

MARK = "aa_mark_"
BUNDLE_SPAN = "aa.bundle"
SPAN_PREFIX = "aa."
# the next chunk's upload, on the pipeline's side stream, is no block's work
UPLOAD = "Memcpy HtoD"


def _marker_block(name: str) -> str:
    """`aa_mark_bands` (or a demangled `aa_mark_bands()`) -> `bands`."""
    return name[len(MARK):].split("(")[0]


def _covered(merged: List[Tuple[float, float]], starts: List[float], lo: float, hi: float) -> float:
    """Length of [lo, hi] that the sorted disjoint intervals `merged`
    (their starts in `starts`) cover."""
    total = 0.0
    i = max(0, bisect.bisect_right(starts, lo) - 1)
    while i < len(merged) and merged[i][0] < hi:
        a, b = merged[i]
        total += max(0.0, min(b, hi) - max(a, lo))
        i += 1
    return total


def block_device_ms(ctx, block: str) -> float | None:
    """Milliseconds a call of the engine block `block`: the union of the
    device intervals from each of the block's markers to the next marker,
    the markers and host-to-device copies left out, summed over the
    window's chunks and divided by the window's calls."""
    view = ctx.trace
    if view is None or not ctx.records:
        return None
    lo_w, hi_w = view.window
    marks = sorted((a, _marker_block(n)) for n, a, b in view.device
                   if n.startswith(MARK) and a >= lo_w and b <= hi_w)
    if not marks:
        return None
    work = stats.union((a, b) for n, a, b in view.device if not n.startswith(MARK) and UPLOAD not in n)
    starts = [a for a, _b in work]
    total, found = 0.0, False
    for (a, name), (nxt, _next_name) in zip(marks, marks[1:]):
        if name == block:
            found = True
            total += _covered(work, starts, a, nxt)
    return 1e3 * total / len(ctx.records) if found else None


def span_ms(ctx, name: str) -> float | None:
    """Milliseconds a call in the program's span `name`: its summed
    durations inside the window over the window's calls."""
    view = ctx.trace
    if view is None or not ctx.records:
        return None
    lo_w, hi_w = view.window
    found = [b - a for n, a, b in view.spans if n == name and a >= lo_w and b <= hi_w]
    return 1e3 * sum(found) / len(ctx.records) if found else None


def idle_unnamed_share(ctx) -> float | None:
    """Per cent of the device-idle time inside the program's `aa.bundle`
    spans that none of its other `aa.*` spans covers."""
    view = ctx.trace
    if view is None:
        return None
    lo_w, hi_w = view.window
    calls = [(a, b) for n, a, b in view.spans if n == BUNDLE_SPAN and a >= lo_w and b <= hi_w]
    if not calls:
        return None
    named = stats.union((a, b) for n, a, b in view.spans if n.startswith(SPAN_PREFIX) and n != BUNDLE_SPAN)
    starts = [a for a, _b in named]
    device = view.device_intervals()
    idle = unnamed = 0.0
    for a, b in calls:
        for g0, g1 in stats.gaps(device, a, b):
            idle += g1 - g0
            unnamed += (g1 - g0) - _covered(named, starts, g0, g1)
    return 100.0 * unnamed / idle if idle > 0 else None
