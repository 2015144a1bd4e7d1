"""Host ms an MCS of the program's span ``repro_torch.chunk`` (one
chunk's enqueue) less its ``repro_torch.keychain``,
``repro_torch.schedule_copy`` and ``repro_torch.ring_push`` children, over
the window's untraced first half: the host's launches of the updates,
counts and rows, and its copies to the host."""
from escgbench.spans import read_host


def read(ctx):
    return read_host(ctx, "chunk",
                     less=("keychain", "schedule_copy", "ring_push"))
