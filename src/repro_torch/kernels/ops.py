"""Launch wrappers around the kernels (port of ``repro.kernels.ops``): the
torus roll, which the reference keeps outside its Pallas calls, is fused
into the tile loads of K1, K2 and K3, and the reference engine's
sequential scan is S1. The ``*_trials`` forms run K1, K2, K3 and K4 over a
batch of IID trials, one launch for all; the ``*_table`` forms run K1 and
K3 over every block of every trial of a card, and
``density_counts_sharded_trials`` K4s per trial, for a trial batch
decomposed over a ('pod', 'rows', 'cols') mesh. ``launches``/
``reset_launches`` read and clear every kernel's launch count, each form's
under its own name."""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..core.rng import ProposalBatch
from . import density as density_kernel
from . import escg_update as escg_kernel
from . import escg_update_fused as fused
from . import philox as philox_kernel
from . import reference_scan as scan_kernel
from .philox import philox_bits, philox_uniform
from .reference_scan import reference_scan

__all__ = ["escg_round", "escg_round_fused", "escg_rounds_fused",
           "density_counts", "escg_round_trials", "escg_round_fused_trials",
           "escg_rounds_fused_trials", "density_counts_trials",
           "escg_round_fused_table", "escg_round_table",
           "density_counts_sharded_trials",
           "philox_bits", "philox_uniform", "reference_scan", "launches",
           "reset_launches"]

_COUNTED = (fused, escg_kernel, density_kernel, philox_kernel, scan_kernel)


def launches() -> Dict[str, int]:
    """Kernel name -> launches since the last reset."""
    out = {}
    for mod in _COUNTED:
        out.update(mod.LAUNCHES)
    return out


def reset_launches() -> None:
    for mod in _COUNTED:
        for name in mod.LAUNCHES:
            mod.LAUNCHES[name] = 0


def escg_round(grid: torch.Tensor, props: ProposalBatch,
               shift: Tuple[int, int], dom: torch.Tensor, dirs: torch.Tensor,
               tile_shape: Tuple[int, int], t_eps: float, t_eps_mu: float,
               roll_back: bool = True) -> torch.Tensor:
    """Stream-fed sublattice round, the kernel twin of
    ``sublattice.run_round``: one K3 launch with the (T, K) proposals that
    reads the grid rolled by ``-shift``, and a roll back unless
    ``roll_back=False`` (the engines let the frame drift)."""
    dy, dx = int(shift[0]), int(shift[1])
    g = escg_kernel.escg_tile_round(grid, props.cell, props.dirn,
                                    props.u_act, props.u_dom, dom, dirs,
                                    tile_shape, t_eps, t_eps_mu, (dy, dx))
    if roll_back:
        g = torch.roll(g, (dy, dx), (0, 1))
    return g


def escg_round_fused(grid: torch.Tensor, seed: Tuple[int, int],
                     round_idx: int, shift: Tuple[int, int],
                     dom: torch.Tensor, dirs: torch.Tensor,
                     tile_shape: Tuple[int, int], k_per_tile: int,
                     t_eps: float, t_eps_mu: float, neighbourhood: int = 4,
                     roll_back: bool = True,
                     tile_offset: Tuple[int, int] = (0, 0),
                     grid_tiles_w: Optional[int] = None) -> torch.Tensor:
    """Fused-PRNG sublattice round: one K1 launch that reads the grid
    rolled by ``-shift``, and a roll back unless ``roll_back=False`` (the
    engines let the frame drift)."""
    dy, dx = int(shift[0]), int(shift[1])
    g = fused.escg_tile_round_fused(
        grid, seed, round_idx, dom, dirs, tile_shape, k_per_tile, t_eps,
        t_eps_mu, neighbourhood, tile_offset, grid_tiles_w, (dy, dx))
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


def density_counts(grid: torch.Tensor, species: int) -> torch.Tensor:
    """Counts per label 0..S, (S+1,) int32 (K4 on the card)."""
    return density_kernel.density_counts(grid, species)


def escg_round_trials(grids: torch.Tensor, props: ProposalBatch,
                      shifts: torch.Tensor, dom: torch.Tensor,
                      dirs: torch.Tensor, tile_shape: Tuple[int, int],
                      t_eps: float, t_eps_mu: float) -> torch.Tensor:
    """Stream-fed round of every trial of an (n, H, W) batch in one K3
    launch, each trial read rolled by its row of ``shifts`` ((n, 2) int64
    on the grids' device) and left in its rolled frame."""
    return escg_kernel.escg_tile_round_trials(
        grids, props.cell, props.dirn, props.u_act, props.u_dom, dom, dirs,
        tile_shape, t_eps, t_eps_mu, shifts)


def escg_round_fused_trials(grids: torch.Tensor, seeds: torch.Tensor,
                            shifts: torch.Tensor, dom: torch.Tensor,
                            dirs: torch.Tensor, tile_shape: Tuple[int, int],
                            k_per_tile: int, t_eps: float, t_eps_mu: float,
                            neighbourhood: int = 4) -> torch.Tensor:
    """Fused-PRNG round of every trial of an (n, H, W) batch in one K1
    launch, with each trial's seed words and shift ((n, 2) int64 on the
    grids' device); the frames drift."""
    return fused.escg_tile_round_fused_trials(
        grids, seeds, shifts, dom, dirs, tile_shape, k_per_tile, t_eps,
        t_eps_mu, neighbourhood)


def escg_rounds_fused_trials(grids: torch.Tensor, seeds: torch.Tensor,
                             shifts: torch.Tensor, dom: torch.Tensor,
                             dirs: torch.Tensor,
                             tile_shape: Tuple[int, int], k_per_tile: int,
                             t_eps: float, t_eps_mu: float, species: int,
                             neighbourhood: int = 4):
    """K fused MCS of every trial of an (n, H, W) batch in one K2 launch,
    seeds and shifts (n, K, 2); returns ``(grids, counts (n, K, S+1))``."""
    return fused.escg_tile_rounds_fused_trials(
        grids, seeds, shifts, dom, dirs, tile_shape, k_per_tile, t_eps,
        t_eps_mu, species, neighbourhood)


def density_counts_trials(grids: torch.Tensor, species: int) -> torch.Tensor:
    """Counts per label 0..S of each trial of a batch, (n, S+1) int32 (K4
    per trial on the card)."""
    return density_kernel.density_counts_trials(grids, species)


def escg_round_fused_table(sources: Sequence[torch.Tensor],
                           seeds: Sequence[torch.Tensor],
                           shifts: Sequence[torch.Tensor],
                           tile_offsets: Sequence[Tuple[int, int]],
                           block_shape: Tuple[int, int], dom: torch.Tensor,
                           dirs: torch.Tensor, tile_shape: Tuple[int, int],
                           k_per_tile: int, t_eps: float, t_eps_mu: float,
                           neighbourhood: int, grid_tiles_w: int
                           ) -> List[torch.Tensor]:
    """Fused-PRNG round of every block of every trial in one K1 launch:
    run r is a block's (n, sh, sw) cells with their halo, each trial read
    at its own shift with its own seed words; the frames drift."""
    return fused.escg_tile_round_fused_table(
        sources, seeds, shifts, tile_offsets, block_shape, dom, dirs,
        tile_shape, k_per_tile, t_eps, t_eps_mu, neighbourhood,
        grid_tiles_w)


def escg_round_table(sources: Sequence[torch.Tensor],
                     props: Sequence[ProposalBatch],
                     shifts: Sequence[torch.Tensor],
                     block_shape: Tuple[int, int], dom: torch.Tensor,
                     dirs: torch.Tensor, tile_shape: Tuple[int, int],
                     t_eps: float, t_eps_mu: float) -> List[torch.Tensor]:
    """Stream-fed round of every block of every trial in one K3 launch:
    run r is a block's (n, sh, sw) cells with their halo and its (n, T, K)
    proposals, each trial read at its own shift; the frames drift."""
    return escg_kernel.escg_tile_round_table(sources, props, shifts,
                                             block_shape, dom, dirs,
                                             tile_shape, t_eps, t_eps_mu)


def density_counts_sharded_trials(groups: Sequence[Sequence[torch.Tensor]],
                                  species: int) -> torch.Tensor:
    """Counts per label 0..S of each trial of a decomposed trial batch,
    groups of (n, bh, bw) blocks -> (G * n, S+1) int32 (K4s per trial, one
    launch per device)."""
    return density_kernel.density_counts_sharded_trials(groups, species)
