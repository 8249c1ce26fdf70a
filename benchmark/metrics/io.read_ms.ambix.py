"""The prefetch workers' reads of a call's interleaved taps into their
page-locked buffers: the program's phase read_s (the span
aa.io.read_interleaved, summed over the call's chunks), milliseconds, mean
over the traced calls of ambix64.third. A program without the interleaved
read has no such phase and reads None."""

from benchlib import phases


def read(ctx):
    return phases.mean_ms(ctx, ("read_s",))
