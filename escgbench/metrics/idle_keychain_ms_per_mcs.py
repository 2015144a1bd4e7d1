"""Device idle ms an MCS of the traced window whose gaps' middles lie
inside the program's range ``repro_torch.keychain`` (the innermost of
the program's ranges there; gaps as ``trace.py`` computes them): the
card waiting for the host's key chain."""
from escgbench.spans import idle_ms_per_mcs


def read(ctx):
    return idle_ms_per_mcs(ctx, "keychain")
