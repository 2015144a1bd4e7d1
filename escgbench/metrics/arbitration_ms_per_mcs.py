"""Device ms an MCS of the batched engine's arbitration
(``batched.run_proposals_trials``): the kernels launched inside the
``escgbench.arbitration`` range in the traced window, over its MCS."""


def read(ctx):
    return ctx.span_ms_per_mcs("escgbench.arbitration")
