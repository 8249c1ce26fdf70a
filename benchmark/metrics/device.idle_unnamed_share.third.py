"""Share of the device-idle time inside the program's aa.bundle spans that no
other aa.* span covers, in the traced window of bundle64.third."""

from benchlib import blocks


def read(ctx):
    return blocks.idle_unnamed_share(ctx)
