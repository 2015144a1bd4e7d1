"""Launch wrappers around the fused kernels (port of
``repro.kernels.ops``): the torus roll stays outside K1, as the
reference keeps it outside its Pallas call."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import escg_update_fused as fused


def escg_round_fused(grid: torch.Tensor, seed: Tuple[int, int],
                     round_idx: int, shift: Tuple[int, int],
                     dom: torch.Tensor, dirs: torch.Tensor,
                     tile_shape: Tuple[int, int], k_per_tile: int,
                     t_eps: float, t_eps_mu: float, neighbourhood: int = 4,
                     roll_back: bool = True,
                     tile_offset: Tuple[int, int] = (0, 0),
                     grid_tiles_w: Optional[int] = None) -> torch.Tensor:
    """Fused-PRNG sublattice round: roll by ``-shift``, one K1 launch, and
    roll back unless ``roll_back=False`` (the engines let the frame
    drift)."""
    dy, dx = int(shift[0]), int(shift[1])
    g = torch.roll(grid, (-dy, -dx), (0, 1))
    g = fused.escg_tile_round_fused(
        g, seed, round_idx, dom, dirs, tile_shape, k_per_tile, t_eps,
        t_eps_mu, neighbourhood, tile_offset, grid_tiles_w)
    if roll_back:
        g = torch.roll(g, (dy, dx), (0, 1))
    return g


def escg_rounds_fused(grid: torch.Tensor, seeds: torch.Tensor,
                      shifts: torch.Tensor, dom: torch.Tensor,
                      dirs: torch.Tensor, tile_shape: Tuple[int, int],
                      k_per_tile: int, t_eps: float, t_eps_mu: float,
                      species: int, neighbourhood: int = 4,
                      tile_offset: Tuple[int, int] = (0, 0),
                      grid_tiles_w: Optional[int] = None):
    """K fused MCS in one K2 launch: the per-step roll happens in the
    kernel, and the grid comes back in the drifted frame of the last step
    with the (K, species + 1) per-step counts."""
    return fused.escg_tile_rounds_fused(
        grid, seeds, shifts, dom, dirs, tile_shape, k_per_tile, t_eps,
        t_eps_mu, species, neighbourhood, tile_offset, grid_tiles_w)
