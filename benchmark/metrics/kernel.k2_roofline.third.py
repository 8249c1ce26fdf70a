"""K2's share of its roofline over its two instances (shared STFT, modal
STFT) in bundle64.third: bound time of the work the traced calls
ask of K2 (benchmark/rooflines/k2.py), over K2's summed device time."""

from benchlib import phases


def read(ctx):
    return phases.roofline_share(ctx, "k2", "stft_mag_kernel")
