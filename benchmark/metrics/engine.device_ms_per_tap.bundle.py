"""Device-busy time (the union of the trace's device intervals) over the
taps answered in the traced window of bundle64.three."""

from benchlib import phases


def read(ctx):
    return phases.device_ms_per_op(ctx)
