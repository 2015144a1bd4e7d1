"""Host ms an MCS of the program's span ``repro_torch.keychain`` (the
study's key chain, ``schedule_batch``, at its call in the trial chunk)
over the window's untraced first half: the key chain as the study ran
it, beside the card's work."""
from escgbench.spans import read_host


def read(ctx):
    return read_host(ctx, "keychain")
