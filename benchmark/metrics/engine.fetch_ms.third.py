"""The packed device-to-host copies of a call, waiting out the device
included: phases fetch_s, mean over the traced calls of bundle64.third."""

from benchlib import phases


def read(ctx):
    return phases.mean_ms(ctx, ("fetch_s",))
