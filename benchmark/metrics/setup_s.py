"""Set-up: process start to the first timed call (imports, card, inputs, warm-up)."""


def read(ctx):
    return ctx.setup_s
