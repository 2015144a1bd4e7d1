"""Host ms an MCS of the program's span ``repro_torch.wait`` (the host
blocked on a chunk's event for its outputs) over the window's untraced
first half."""
from escgbench.spans import read_host


def read(ctx):
    return read_host(ctx, "wait")
