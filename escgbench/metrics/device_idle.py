"""1 - device busy / wall an MCS, in percent: the busy time from the
profiler's trace (``trace.py``) over the traced window's MCS, the wall
from the window's untraced first half, which the profiler's host work
does not slow."""


def read(ctx):
    t = ctx.trace
    wall = ctx.untraced_s_per_mcs()
    if not t or t["busy_s"] <= 0 or not t["mcs"] or not wall:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["mcs"] / wall)
