"""The whole step's share of the card's peak: the least time of one MCS
of every trial's work (the update, the counts and the declared
observables, from the engine's work file; the lattice read once and
written once) over the wall an MCS of the window's untraced first half,
in percent."""


def read(ctx):
    wall = ctx.untraced_s_per_mcs()
    if not wall:
        return None
    return 100.0 * ctx.least_s() / wall
