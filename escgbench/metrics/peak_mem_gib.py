"""``torch.cuda.max_memory_allocated()`` of the run, read when the window
closes: it sets how many trials of a lattice fit on one card."""


def read(ctx):
    return ctx.clock.peak_bytes / 2 ** 30 if ctx.clock.peak_bytes else None
