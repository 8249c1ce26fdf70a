"""Share of the traced window of bundle64.three in which the device ran nothing."""

from benchlib import phases


def read(ctx):
    return phases.idle_share(ctx)
