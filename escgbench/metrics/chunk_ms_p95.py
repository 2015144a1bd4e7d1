"""The 95th percentile, over every chunk of the window, of the wall time
from one chunk's hook call to the next: what a study's progress, hooks,
checkpoints and stop-on-stasis wait for."""
import numpy as np


def read(ctx):
    return float(np.percentile(ctx.clock.intervals_ms(), 95))
