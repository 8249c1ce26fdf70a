"""The report's host work on a call: phases markdown_s + json_s, mean over
the traced calls of bundle64.three."""

from benchlib import phases


def read(ctx):
    return phases.mean_ms(ctx, ("markdown_s", "json_s"))
