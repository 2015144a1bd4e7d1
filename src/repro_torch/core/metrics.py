"""Densities and stasis detection (port of ``repro.core.metrics``, paper
§3.2.2). The counts are kernel K4 (``kernels/density.py``) on the grid's
device, where the reference takes them with ``jnp.bincount``."""
from __future__ import annotations

import torch

from .lattice import counts

__all__ = ["counts", "alive_species", "stasis"]


def alive_species(cnt: torch.Tensor) -> torch.Tensor:
    """Number of species (excluding empties) with non-zero population."""
    return (cnt[..., 1:] > 0).sum(dim=-1)


def stasis(cnt: torch.Tensor) -> torch.Tensor:
    """Paper §3.2.2: stable when at most one species remains active."""
    return alive_species(cnt) <= 1
