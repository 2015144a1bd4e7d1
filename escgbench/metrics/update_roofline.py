"""The update's share of its roofline: the least time of the update's work
for one MCS of every trial (the engine's work file) over the device time
an MCS of the kernels launched inside the ``escgbench.update`` range (the
engine's ``one_mcs_batch``; on ``batched`` its draws and arbitration with
it) in the traced window, in percent."""


def read(ctx):
    ms = ctx.span_ms_per_mcs("escgbench.update")
    if not ms:
        return None
    return 100.0 * ctx.least_s(["update"]) / (ms * 1e-3)
