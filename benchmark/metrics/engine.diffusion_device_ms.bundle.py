"""Device milliseconds a call of the engine's diffusion block in the traced
window of bundle64.three: the union of device intervals from each aa_mark_diffusion
marker to the next marker, summed over the chunks (benchlib/blocks.py)."""

from benchlib import blocks


def read(ctx):
    return blocks.block_device_ms(ctx, "diffusion")
