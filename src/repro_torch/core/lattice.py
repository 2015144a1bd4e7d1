"""Lattice construction (port of ``repro.core.lattice``, paper §3.1.1).

The grid is an (H, W) integer tensor; 0 = empty, 1..S = species.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import threefry
from .device import DeviceLike, resolve_device

# Direction tables. First 4 entries = von Neumann (up, down, left, right,
# matching the paper's ordering); entries 4..7 add the Moore diagonals.
DIRS = np.array(
    [(-1, 0), (1, 0), (0, -1), (0, 1),
     (-1, -1), (-1, 1), (1, -1), (1, 1)], dtype=np.int32)


def init_grid(key: torch.Tensor, height: int, width: int, species: int,
              empty_prob: float = 0.0, dtype: torch.dtype = torch.int32,
              device: Optional[DeviceLike] = None) -> torch.Tensor:
    """Uniform random initialization (paper §3.1.1): each cell is empty with
    probability ``empty_prob`` else uniform over species 1..S. The 2·H·W
    threefry words are drawn on ``device`` (default: the card)."""
    dev = resolve_device(device)
    k1, k2 = threefry.split(key)
    # a Python float meets float32 draws as float32 (JAX weak typing)
    threshold = torch.tensor(empty_prob, dtype=torch.float32, device=dev)
    occupied = threefry.uniform(k1, (height, width), device=dev) >= threshold
    labels = threefry.randint(k2, (height, width), 1, species + 1,
                              device=dev)
    return torch.where(occupied, labels, 0).to(dtype)


def counts(grid: torch.Tensor, species: int) -> torch.Tensor:
    """Population counts per label 0..S (0 = empties), (S+1,) int32 on the
    grid's device: kernel K4 on the card, its plain version on the CPU."""
    from ..kernels.density import density_counts  # kernels import core
    return density_counts(grid, species)
