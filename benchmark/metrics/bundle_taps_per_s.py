"""Every tap answered in the window over the window's whole length."""

from benchlib import stats


def read(ctx):
    return stats.rate(ctx.ops, ctx.window_s)
