"""Host ms an MCS of the program's span ``repro_torch.fold`` (the flush
of the observables' ring and the fold of the masks into the statistics)
over the window's untraced first half."""
from escgbench.spans import read_host


def read(ctx):
    return read_host(ctx, "fold")
