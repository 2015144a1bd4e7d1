"""Lattice construction and neighbour indexing (port of
``repro.core.lattice``, paper §3.1.1).

The grid is an (H, W) integer tensor; 0 = empty, 1..S = species. Proposal
streams address it by flat index, ``index = row * W + col``. Boundaries:
``flux=True`` wraps (periodic, the paper's default); ``flux=False`` clamps
an out-of-bounds neighbour to the nearest edge cell, as the reference's
code does (its docstring calls this "reflect").
"""
from __future__ import annotations

from typing import Optional, Tuple

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


def trial_counts(grids: torch.Tensor, species: int) -> torch.Tensor:
    """Population counts per label 0..S of each lattice of an (n, H, W)
    trial batch, (n, S+1) int32 on its device: kernel K4 per trial on the
    card (one launch), its plain version on the CPU."""
    from ..kernels.density import density_counts_trials  # kernels import core
    return density_counts_trials(grids, species)


def neighbor_rc(row: torch.Tensor, col: torch.Tensor,
                direction: torch.Tensor, height: int, width: int,
                flux: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Neighbour (row, col) for a direction id, under the boundary rule."""
    dirs = torch.as_tensor(DIRS, device=row.device)
    d = direction.long()
    nr, nc = row + dirs[d, 0], col + dirs[d, 1]
    if flux:
        nr = torch.remainder(nr + height, height)
        nc = torch.remainder(nc + width, width)
    else:
        nr = nr.clamp(0, height - 1)
        nc = nc.clamp(0, width - 1)
    return nr, nc


def neighbor_index(cell: torch.Tensor, direction: torch.Tensor, height: int,
                   width: int, flux: bool) -> torch.Tensor:
    """Flat-index neighbour of each cell (int32 for int32 cells)."""
    row = torch.div(cell, width, rounding_mode="floor")
    col = torch.remainder(cell, width)
    nr, nc = neighbor_rc(row, col, direction, height, width, flux)
    return nr * width + nc


def densities(grid: torch.Tensor, species: int) -> torch.Tensor:
    """Share of each label 0..S, float32 on the grid's device."""
    return counts(grid, species) / grid.numel()
