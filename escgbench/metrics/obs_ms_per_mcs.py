"""Device ms an MCS of the observables' rows (the declared set): the
kernels launched inside the ``escgbench.observables`` range in the traced
window, over its MCS."""


def read(ctx):
    return ctx.span_ms_per_mcs("escgbench.observables")
