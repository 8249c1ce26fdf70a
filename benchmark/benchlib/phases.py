"""Helpers the per-layer readers share: the program's own `phases` spans of
each call, and a kernel's roofline share from the trace."""

from __future__ import annotations

from benchlib import spec


def mean_ms(ctx, keys) -> float | None:
    """Mean over the window's answered calls of the sum of `keys` in the
    program's phases, in milliseconds."""
    sums = []
    for rec in ctx.records:
        ph = ctx.entry.phases(rec)
        if ph and all(k in ph for k in keys):
            sums.append(sum(float(ph[k]) for k in keys))
    return 1e3 * sum(sums) / len(sums) if sums else None


def roofline_share(ctx, kernel: str, fragment: str) -> float | None:
    """Per cent: the bound time of the work the window's calls ask of
    `kernel`, counted from the calls' shapes and not from its launches, over
    the summed device time of the trace's events whose name holds
    `fragment`, however many launches that work took."""
    if ctx.trace is None:
        return None
    lo, hi = ctx.trace.window
    busy = sum(b - a for _n, a, b in ctx.trace.kernels(fragment) if a >= lo and b <= hi)
    if busy <= 0:
        return None
    roof = spec.roofline(kernel)
    bound = len(ctx.records) * sum(roof.bound_s(w) for w in ctx.entry.kernel_work()[kernel])
    return 100.0 * bound / busy


def replay_share(ctx) -> float | None:
    """Per cent of the window's chunk steps replayed from a CUDA graph."""
    steps = ctx.entry.chunks_per_call() * len(ctx.records)
    replays = ctx.counters[1]["replays"] - ctx.counters[0]["replays"]
    return 100.0 * replays / steps if steps else None


def device_ms_per_op(ctx) -> float | None:
    """Device-busy milliseconds of the traced window over its operations."""
    if ctx.trace is None or not ctx.ops:
        return None
    busy = ctx.trace.busy_s()
    return 1e3 * busy / ctx.ops if busy > 0 else None


def idle_share(ctx) -> float | None:
    """Per cent of the traced window in which the device ran nothing."""
    if ctx.trace is None or not ctx.trace.device:
        return None
    from benchlib import stats

    return stats.idle_share(ctx.trace.device_intervals(), *ctx.trace.window)
