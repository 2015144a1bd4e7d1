"""Device ms an MCS of the batched engine's proposal draws
(``rng.proposal_batch``): the kernels launched inside the
``escgbench.draws`` range in the traced window, over its MCS."""


def read(ctx):
    return ctx.span_ms_per_mcs("escgbench.draws")
