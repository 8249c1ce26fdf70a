"""The program's span aa.report.write (json.dumps, bundle_metrics.json and
the index written), milliseconds a call in the traced window of bundle64.three."""

from benchlib import blocks


def read(ctx):
    return blocks.span_ms(ctx, "aa.report.write")
