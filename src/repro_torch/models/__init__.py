"""Model stack of the LM appendix (port of ``repro.models``, DESIGN.md §9):
the dense, vlm, moe, ssm, hybrid and encdec families."""
from . import (common, encdec, moe, registry, spec, ssm,  # noqa: F401
               transformer)
from .registry import Model, build_model  # noqa: F401
