"""Deterministic synthetic data of the LM appendix (port of ``repro.data``)."""
from .synthetic import SyntheticTokens, batch_for_model  # noqa: F401
