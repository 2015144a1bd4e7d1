"""Site-update attempts of every trial completed in the window, over the
window's seconds: the unit of the paper's Fig 4.3 (updates per second =
N / s per MCS), over all the work and all the time of the window."""


def read(ctx):
    c = ctx.clock
    return ctx.cell.trials * c.window_mcs * ctx.cell.model.n_cells \
        / c.window_s
