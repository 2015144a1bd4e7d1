"""Stream-fed sublattice kernel (port of ``repro.kernels.escg_update``).

K3, ``escg_tile_round``: one round over the lattice rolled by ``-shift``
(default none). Tile t plays the K proposals of row t of the (T, K)
buffers ``cell``, ``dirn``, ``u_act`` and ``u_dom`` (raster tile order,
filled by ``rng.tile_stream_batch``) in order on its interior, and the
result stays in the rolled frame. The CUDA kernel is ``tile_round_kernel``
in ``csrc/escg_update.cu``: K1's shared-memory staging of the tiles (the
roll fused into their load, ``tile_staging.cuh``), fed with the proposals
in double-buffered chunks of ``CHUNK`` per tile; ``staging`` sizes it and
raises for a tile that does not fit. Its plain version is
``core.sublattice.tile_update`` over all tiles.

``escg_tile_round_trials`` is K3 over a batch of IID trials: n lattices
stacked as one (n, H, W) tensor, (n, T, K) proposal fields and (n, 2)
shifts on the card, one launch for all of them; its plain version is the
single-lattice one, trial by trial.

The wrappers launch the kernel for a CUDA grid; for a CPU grid they roll
and take the plain version. ``LAUNCHES`` counts kernel launches, the
trial form's under its own name.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..core import sublattice
from ..core.rng import ProposalBatch
from . import build
from . import escg_update_fused as fused

LAUNCHES = {"escg_tile_round": 0, "escg_tile_round_trials": 0}

_LIB = "escg_update"
# kChunk and kPad of csrc/escg_update.cu: proposals per tile in a chunk, and
# the words of padding after each tile's row of a chunk
CHUNK, CHUNK_PAD = 32, 4
# shared memory a staged tile's proposals take: two chunk buffers of the
# four 32-bit fields
PROPOSAL_BYTES_PER_TILE = 2 * 4 * (CHUNK + CHUNK_PAD) * 4


def _lib() -> ctypes.CDLL:
    lib = build.load(_LIB)
    fn = lib.escg_tile_round
    if fn.argtypes is None:
        i32, ptr, f32 = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
        fn.argtypes = [i32, i32, i32, ptr, ptr, i32, i32, i32, i32, i32,
                       ptr, ptr, ptr, ptr, ptr, i32, ptr, f32, f32, i32, i32,
                       i32, ptr]
        fn.restype = i32
        fn = lib.escg_tile_round_trials
        fn.argtypes = [i32, i32, i32, ptr, ptr, i32, i32, i32, i32, i32, i32,
                       ptr, ptr, ptr, ptr, ptr, i32, ptr, f32, f32, ptr, i32,
                       ptr]
        fn.restype = i32
    return lib


def staging(tile_shape: Tuple[int, int], cell_bytes: int,
            n_dom: int) -> Tuple[int, int]:
    """``(stage_bytes, tiles_per_block)`` of K3: K1's staging of the tiles
    (``escg_update_fused.staging``) with room beside each tile for its
    proposal chunks. Raises ``ValueError`` if not one tile fits."""
    return fused.staging(tile_shape, cell_bytes, n_dom,
                         PROPOSAL_BYTES_PER_TILE)


def _check(grid: torch.Tensor, cell: torch.Tensor, dirn: torch.Tensor,
           u_act: torch.Tensor, u_dom: torch.Tensor,
           tile_shape: Tuple[int, int]) -> int:
    """Validate the lattice and the proposal buffers; returns K."""
    if grid.dim() != 2 or grid.dtype not in build.CELL_DTYPES:
        raise ValueError(f"grid must be a 2-D int8/int16/int32 tensor, got "
                         f"{tuple(grid.shape)} {grid.dtype}")
    h, w = grid.shape
    th, tw = tile_shape
    if th < 3 or tw < 3 or h % th or w % tw:
        raise ValueError(f"tile {tile_shape} must be >= 3x3 and divide "
                         f"the grid {h}x{w}")
    n_tiles = (h // th) * (w // tw)
    if cell.dim() != 2 or cell.shape[0] != n_tiles:
        raise ValueError(f"proposals must be ({n_tiles}, K) for "
                         f"{n_tiles} tiles, got {tuple(cell.shape)}")
    for name, t, dt in (("cell", cell, torch.int32),
                        ("dirn", dirn, torch.int32),
                        ("u_act", u_act, torch.float32),
                        ("u_dom", u_dom, torch.float32)):
        if t.dtype != dt or t.shape != cell.shape \
                or t.device != grid.device:
            raise ValueError(f"{name} must be {tuple(cell.shape)} {dt} on "
                             f"{grid.device}, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
    return cell.shape[1]


def escg_tile_round_plain(grid: torch.Tensor, cell: torch.Tensor,
                          dirn: torch.Tensor, u_act: torch.Tensor,
                          u_dom: torch.Tensor, dom: torch.Tensor,
                          tile_shape: Tuple[int, int], t_eps: float,
                          t_eps_mu: float) -> torch.Tensor:
    """Plain version of K3 (same function, any device): the tile sweep of
    ``core.sublattice`` over every tile."""
    h, w = grid.shape
    th, tw = tile_shape
    tiles = sublattice.tile_update(
        sublattice.to_tiles(grid, th, tw),
        ProposalBatch(cell, dirn, u_act, u_dom), t_eps, t_eps_mu, dom)
    return sublattice.from_tiles(tiles, h, w)


def escg_tile_round(grid: torch.Tensor, cell: torch.Tensor,
                    dirn: torch.Tensor, u_act: torch.Tensor,
                    u_dom: torch.Tensor, dom: torch.Tensor,
                    dirs: torch.Tensor, tile_shape: Tuple[int, int],
                    t_eps: float, t_eps_mu: float,
                    shift: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """One sublattice round over the (H, W) grid rolled by ``-shift`` (the
    kernel reads the rolled cells; the default leaves the grid as it is);
    returns a new grid in the rolled frame. ``cell``/``dirn`` (T, K) int32
    and ``u_act``/``u_dom`` (T, K) float32 in raster tile order, with
    ``cell`` in [0, interior) and ``dirn`` a row of ``dirs``; ``dom`` the
    padded (S+1, S+1) float32 dominance matrix and ``dirs`` the (8, 2)
    int32 direction table, all on the grid's device."""
    k = _check(grid, cell, dirn, u_act, u_dom, tile_shape)
    build.check_tables(grid, dom, dirs)
    dy, dx = int(shift[0]), int(shift[1])
    if grid.device.type == "cpu":
        if dy or dx:
            grid = torch.roll(grid, (-dy, -dx), (0, 1))
        return escg_tile_round_plain(grid, cell, dirn, u_act, u_dom, dom,
                                     tile_shape, t_eps, t_eps_mu)
    stage, per_block = staging(tile_shape, grid.element_size(),
                               dom.shape[0])
    device, stream = build.launch_args(grid)
    h, w = grid.shape
    th, tw = tile_shape
    out = torch.empty_like(grid)
    lib = _lib()
    err = lib.escg_tile_round(
        grid.element_size(), stage, per_block, build.ptr(out),
        build.ptr(grid), h, w, th, tw, int(k), build.ptr(cell),
        build.ptr(dirn), build.ptr(u_act), build.ptr(u_dom), build.ptr(dom),
        dom.shape[0], build.ptr(dirs), float(t_eps), float(t_eps_mu),
        dy % h, dx % w, device, stream)
    build.check(lib, err, "escg_tile_round launch")
    LAUNCHES["escg_tile_round"] += 1
    return out


# ---------------------- the trial form: K3 per batch ----------------------- #

def escg_tile_round_trials_plain(grids: torch.Tensor, cell: torch.Tensor,
                                 dirn: torch.Tensor, u_act: torch.Tensor,
                                 u_dom: torch.Tensor, dom: torch.Tensor,
                                 tile_shape: Tuple[int, int], t_eps: float,
                                 t_eps_mu: float,
                                 shifts: torch.Tensor) -> torch.Tensor:
    """Plain version of K3 over trials: each trial rolled by its shift and
    swept with its (T, K) proposals by the plain K3."""
    return torch.stack([
        escg_tile_round_plain(torch.roll(g, (-dy, -dx), (0, 1)), c, d, ua,
                              ud, dom, tile_shape, t_eps, t_eps_mu)
        for g, c, d, ua, ud, (dy, dx) in zip(grids, cell, dirn, u_act,
                                             u_dom, shifts.tolist())])


def escg_tile_round_trials(grids: torch.Tensor, cell: torch.Tensor,
                           dirn: torch.Tensor, u_act: torch.Tensor,
                           u_dom: torch.Tensor, dom: torch.Tensor,
                           dirs: torch.Tensor, tile_shape: Tuple[int, int],
                           t_eps: float, t_eps_mu: float,
                           shifts: torch.Tensor) -> torch.Tensor:
    """One sublattice round of every trial of the (n, H, W) batch in one
    K3 launch: trial t reads its lattice rolled by ``-shifts[t]`` ((n, 2)
    int64 on the grids' device) and plays its (T, K) slice of the (n, T,
    K) proposal fields; returns the new batch in the rolled frames."""
    if grids.dim() != 3 or not 1 <= grids.shape[0] <= fused.MAX_TRIALS:
        raise ValueError(f"a trial batch is (n, H, W) with 1 <= n <= "
                         f"{fused.MAX_TRIALS}, got {tuple(grids.shape)}")
    n = grids.shape[0]
    if cell.dim() != 3 or cell.shape[0] != n:
        raise ValueError(f"proposals must be ({n}, T, K), got "
                         f"{tuple(cell.shape)}")
    for t in (dirn, u_act, u_dom):
        if t.shape != cell.shape:
            raise ValueError(f"the proposal fields differ in shape: "
                             f"{tuple(t.shape)} beside {tuple(cell.shape)}")
    k = _check(grids[0], cell[0], dirn[0], u_act[0], u_dom[0], tile_shape)
    if shifts.dtype != torch.int64 or tuple(shifts.shape) != (n, 2) \
            or shifts.device != grids.device:
        raise ValueError(f"shifts must be ({n}, 2) int64 on {grids.device}, "
                         f"got {tuple(shifts.shape)} {shifts.dtype} on "
                         f"{shifts.device}")
    build.check_tables(grids, dom, dirs)
    if grids.device.type == "cpu":
        return escg_tile_round_trials_plain(grids, cell, dirn, u_act, u_dom,
                                            dom, tile_shape, t_eps, t_eps_mu,
                                            shifts)
    stage, per_block = staging(tile_shape, grids.element_size(),
                               dom.shape[0])
    device, stream = build.launch_args(grids)
    _, h, w = grids.shape
    th, tw = tile_shape
    out = torch.empty_like(grids)
    lib = _lib()
    err = lib.escg_tile_round_trials(
        grids.element_size(), stage, per_block, build.ptr(out),
        build.ptr(grids), n, h, w, th, tw, int(k), build.ptr(cell),
        build.ptr(dirn), build.ptr(u_act), build.ptr(u_dom), build.ptr(dom),
        dom.shape[0], build.ptr(dirs), float(t_eps), float(t_eps_mu),
        build.ptr(shifts), device, stream)
    build.check(lib, err, "escg_tile_round_trials launch")
    LAUNCHES["escg_tile_round_trials"] += 1
    return out
