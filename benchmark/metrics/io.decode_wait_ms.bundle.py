"""A call's probe (headers, lengths) and the time its pipeline waited on
decode and upload: the program's phases probe_s + decode_wait_s, mean over
the traced calls of bundle64.three."""

from benchlib import phases


def read(ctx):
    return phases.mean_ms(ctx, ("probe_s", "decode_wait_s"))
