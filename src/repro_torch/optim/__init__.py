"""Optimizers of the LM appendix (port of ``repro.optim``)."""
from .optimizers import (Optimizer, adafactor, adamw,  # noqa: F401
                         clip_by_global_norm, cosine_schedule, get_optimizer,
                         global_norm)
