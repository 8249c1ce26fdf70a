"""The program's span aa.report.tail (from the last chunk's fetch to the
call's return: that chunk's summaries and encoding, the head of
bundle_metrics.json, the join and both writes), milliseconds a call in the
traced window of ambix64.third. A program without the span reads None."""

from benchlib import blocks


def read(ctx):
    return blocks.span_ms(ctx, "aa.report.tail")
