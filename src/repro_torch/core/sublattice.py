"""Shifted-window synchronous sublattice sweep (port of
``repro.core.sublattice``, DESIGN.md §2).

The torus is cut into (th x tw) tiles. Every tile applies its K interior
proposals in order; proposal cells are restricted to the tile interior
(inset 1) so no tile writes outside itself. ``tile_update`` here is the
plain version of the tile sweep that the CUDA kernels run one thread per
tile: a loop over the K proposals, each step vectorised over all tiles.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .lattice import DIRS
from .rng import ProposalBatch
from .rules import apply_pair


def tile_update(tiles: torch.Tensor, props: ProposalBatch, t_eps: float,
                t_eps_mu: float, dom: torch.Tensor) -> torch.Tensor:
    """Apply each tile's K proposals in order: ``tiles`` (T, th, tw),
    ``props`` fields (T, K). Returns the updated tiles (a new tensor)."""
    t, th, tw = tiles.shape
    iw = tw - 2
    dirs = torch.as_tensor(DIRS, dtype=torch.int64, device=tiles.device)
    flat = tiles.reshape(t, th * tw).clone()
    rows = torch.arange(t, device=tiles.device)
    cell = props.cell.long()
    r = 1 + cell // iw
    c = 1 + cell % iw
    d = dirs[props.dirn.long()]
    here = r * tw + c
    there = (r + d[..., 0]) * tw + (c + d[..., 1])
    for j in range(cell.shape[1]):
        s = flat[rows, here[:, j]]
        n = flat[rows, there[:, j]]
        ns, nn = apply_pair(s, n, props.u_act[:, j], props.u_dom[:, j],
                            t_eps, t_eps_mu, dom)
        flat[rows, here[:, j]] = ns
        flat[rows, there[:, j]] = nn
    return flat.reshape(t, th, tw)


def to_tiles(grid: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """(H, W) -> (T, th, tw), raster tile order."""
    h, w = grid.shape
    return (grid.reshape(h // th, th, w // tw, tw)
                .permute(0, 2, 1, 3)
                .reshape(-1, th, tw))


def from_tiles(tiles: torch.Tensor, h: int, w: int) -> torch.Tensor:
    t, th, tw = tiles.shape
    return (tiles.reshape(h // th, w // tw, th, tw)
                 .permute(0, 2, 1, 3)
                 .reshape(h, w))


def run_round(grid: torch.Tensor, props: ProposalBatch,
              shift: Tuple[int, int], tile_shape: Tuple[int, int],
              t_eps: float, t_eps_mu: float, dom: torch.Tensor,
              roll_back: bool = True) -> torch.Tensor:
    """One shifted-window round over the whole lattice (the plain
    ``sublattice`` engine): roll by ``-shift``, sweep every tile with its
    (T, K) proposals, and roll back unless ``roll_back=False``."""
    h, w = grid.shape
    th, tw = tile_shape
    dy, dx = int(shift[0]), int(shift[1])
    g = torch.roll(grid, (-dy, -dx), (0, 1))
    tiles = tile_update(to_tiles(g, th, tw), props, t_eps, t_eps_mu, dom)
    g = from_tiles(tiles, h, w)
    if roll_back:
        g = torch.roll(g, (dy, dx), (0, 1))
    return g


def roll_trials(grids: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """Each lattice of an (n, H, W) batch rolled by minus its row of
    ``shifts`` ((n, 2) int64): ``out[t, r, c] = grids[t, (r + dy) % H, (c
    + dx) % W]``, as ``torch.roll(grids[t], (-dy, -dx), (0, 1))``."""
    n, h, w = grids.shape
    dev = grids.device
    sh = shifts.to(device=dev, dtype=torch.int64)
    rows = (torch.arange(h, device=dev)[None, :] + sh[:, :1]) % h
    cols = (torch.arange(w, device=dev)[None, :] + sh[:, 1:]) % w
    idx = (rows[:, :, None] * w + cols[:, None, :]).reshape(n, -1)
    return torch.gather(grids.reshape(n, -1), 1, idx).reshape(n, h, w)


def run_round_trials(grids: torch.Tensor, props: ProposalBatch,
                     shifts: torch.Tensor, tile_shape: Tuple[int, int],
                     t_eps: float, t_eps_mu: float,
                     dom: torch.Tensor) -> torch.Tensor:
    """``run_round`` of every trial of an (n, H, W) batch with
    ``roll_back=False``, vectorised over the trials: each lattice rolled
    by its own shift, then one sweep of all n * T tiles with the (n, T, K)
    proposals. Trial t equals ``run_round(grids[t], props[t], shifts[t],
    ..., roll_back=False)``."""
    n, h, w = grids.shape
    th, tw = tile_shape
    g = roll_trials(grids, shifts)
    tiles = to_tiles(g.reshape(n * h, w), th, tw)   # trial-major tiles
    flat = ProposalBatch(*(f.reshape(-1, f.shape[-1]) for f in props))
    tiles = tile_update(tiles, flat, t_eps, t_eps_mu, dom)
    return from_tiles(tiles, n * h, w).reshape(n, h, w)
