"""Densities, stasis detection and survival statistics (port of
``repro.core.metrics``, paper §3.2.2, §4.3). The counts are kernel K4
(``kernels/density.py``) on the grid's device, where the reference takes
them with ``jnp.bincount``."""
from __future__ import annotations

import numpy as np
import torch

from .lattice import counts

__all__ = ["counts", "densities", "alive_species", "stasis", "survivors",
           "first_extinction_mcs"]


def densities(grid: torch.Tensor, species: int) -> torch.Tensor:
    """(S+1,) float32 share of each label 0..S, col 0 the empties."""
    return counts(grid, species) / grid.numel()


def alive_species(cnt: torch.Tensor) -> torch.Tensor:
    """Number of species (excluding empties) with non-zero population."""
    return (cnt[..., 1:] > 0).sum(dim=-1)


def stasis(cnt: torch.Tensor) -> torch.Tensor:
    """Paper §3.2.2: stable when at most one species remains active."""
    return alive_species(cnt) <= 1


def survivors(grid: torch.Tensor, species: int) -> torch.Tensor:
    """Bool (S,) survival mask, 0-indexed by species - 1 (Park
    experiments)."""
    return counts(grid, species)[1:] > 0


def first_extinction_mcs(density_history: np.ndarray, sp: int) -> int:
    """First MCS at which species ``sp`` (1-indexed) has zero density;
    -1 if it never goes extinct. ``density_history``: (T, S+1) numpy."""
    col = np.asarray(density_history)[:, sp]
    idx = np.nonzero(col == 0.0)[0]
    return int(idx[0]) if idx.size else -1
