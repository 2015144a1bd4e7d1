"""Device kernels per MCS in the traced window (memory copies and sets
left out); the run's line also carries K1's and K4's launches by the
profiler beside the program's own ``LAUNCHES`` counters."""


def read(ctx):
    t = ctx.trace
    if not t or not t["mcs"] or not t["kernels"]:
        return None
    return t["kernels"] / t["mcs"]
