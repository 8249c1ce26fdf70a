"""Device-busy time (the union of the trace's device intervals) over the
16-channel taps answered in the traced window of ambix64.third."""

from benchlib import phases


def read(ctx):
    return phases.device_ms_per_op(ctx)
