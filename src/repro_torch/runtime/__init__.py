"""Checkpointing, fault tolerance and the train step of the LM appendix
(port of ``repro.runtime``, DESIGN.md §9)."""
from . import checkpoint, fault, train_lib  # noqa: F401
