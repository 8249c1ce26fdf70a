"""torch.cuda.max_memory_allocated() over the window, reset after set-up; the
step graphs' pool counts, as it is allocated memory."""


def read(ctx):
    return ctx.peak_alloc_bytes / 2**30 if ctx.peak_alloc_bytes else None
