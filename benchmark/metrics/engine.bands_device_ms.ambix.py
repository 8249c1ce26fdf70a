"""Device milliseconds a call of the engine's bands block in the traced
window of ambix64.third (416 band rows a tap): the union of device
intervals from each aa_mark_bands marker to the next marker, summed over
the chunks (benchlib/blocks.py)."""

from benchlib import blocks


def read(ctx):
    return blocks.block_device_ms(ctx, "bands")
