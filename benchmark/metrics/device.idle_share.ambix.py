"""Share of the traced window of ambix64.third in which the device ran nothing."""

from benchlib import phases


def read(ctx):
    return phases.idle_share(ctx)
