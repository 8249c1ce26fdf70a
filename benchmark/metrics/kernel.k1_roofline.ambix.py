"""K1's share of its roofline in ambix64.third: the bound time of the work
the traced calls ask of K1 at 16 channels a tap (benchmark/rooflines/k1.py),
over K1's summed device time."""

from benchlib import phases


def read(ctx):
    return phases.roofline_share(ctx, "k1", "edc_kernel")
