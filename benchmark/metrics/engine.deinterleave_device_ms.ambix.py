"""Device milliseconds a call of the step's split of each interleaved chunk
into channel planes in the traced window of ambix64.third: the union of
device intervals from each aa_mark_deinterleave marker to the next marker,
summed over the chunks (benchlib/blocks.py). A program without the marker
reads None."""

from benchlib import blocks


def read(ctx):
    return blocks.block_device_ms(ctx, "deinterleave")
