"""Host ms an MCS of the program's host-to-card copies inside a chunk's
enqueue, the spans ``repro_torch.schedule_copy`` (the key chain's copy)
and ``repro_torch.ring_push`` (the rows' push into the device ring, whose
slot indices are copied), over the window's untraced first half: the
host waiting on the card inside a dispatch, where a copy from pageable
memory synchronises the stream."""
from escgbench.spans import read_host


def read(ctx):
    parts = [read_host(ctx, name) for name in ("schedule_copy", "ring_push")]
    found = [p for p in parts if p is not None]
    return sum(found) if found else None
