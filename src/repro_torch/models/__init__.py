"""Model stack of the LM appendix (port of ``repro.models``, DESIGN.md §9):
the dense and vlm families."""
from . import common, registry, spec, transformer  # noqa: F401
from .registry import Model, build_model  # noqa: F401
