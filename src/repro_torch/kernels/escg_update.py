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
single-lattice one, trial by trial. ``escg_tile_round_table`` is K3 over
every block of every trial of a card (``core/sharded_pod.py``): up to
``MAX_RUNS`` runs in one launch, each one block of one pod group read from
the block extended by a halo at each trial's own shift
(``escg_update_fused.halo_windows``) and fed its own (n, T, K) proposals;
its plain version is the plain K3 of each run's windows. One lattice, a
trial batch and a table are one kernel.

The wrappers launch the kernel for a CUDA grid; for a CPU grid they roll
and take the plain version. ``LAUNCHES`` counts kernel launches, the
trial form's under its own name.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from ..core import sublattice
from ..core.rng import ProposalBatch
from . import build
from . import escg_update_fused as fused

LAUNCHES = {"escg_tile_round": 0, "escg_tile_round_trials": 0,
            "escg_tile_round_table": 0}

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
        fn.argtypes = [i32, i32, i32, i32, ptr, ptr, ptr, ptr, i32, i32,
                       i32, i32, i32, i32, i32, i32, ptr, i32, ptr, f32, f32,
                       i32, i32, i32, ptr]
        fn.restype = i32
    return lib


def _launch(outs, ins, fields, shifts, n: int,
            block_shape: Tuple[int, int], tile_shape: Tuple[int, int],
            k: int, dom: torch.Tensor, dirs: torch.Tensor, t_eps: float,
            t_eps_mu: float, shift: Tuple[int, int] = (0, 0)) -> None:
    """One K3 launch over the runs ``ins[r]`` -> ``outs[r]`` (n stacked
    lattices of ``block_shape`` cells each, read from sources of the shape
    of ``ins[r]``'s last two dims), playing ``fields[r]`` (cell, dirn,
    u_act, u_dom), with the runs' (n, 2) ``shifts`` on the card, or
    ``None`` for one lattice read at the scalar ``shift``."""
    first = ins[0]
    h, w = block_shape
    sh, sw = first.shape[-2:]
    th, tw = tile_shape
    stage, per_block = staging(tile_shape, first.element_size(),
                               dom.shape[0])
    device, stream = build.launch_args(first)
    lib = _lib()
    err = lib.escg_tile_round(
        first.element_size(), stage, per_block, len(ins), fused._ptrs(outs),
        fused._ptrs(ins), fused._ptrs([f for run in fields for f in run]),
        None if shifts is None else fused._ptrs(shifts), n, h, w, sh, sw,
        th, tw, int(k), build.ptr(dom), dom.shape[0], build.ptr(dirs),
        float(t_eps), float(t_eps_mu), int(shift[0]), int(shift[1]), device,
        stream)
    build.check(lib, err, "escg_tile_round launch")


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
    h, w = grid.shape
    out = torch.empty_like(grid)
    _launch([out], [grid], [(cell, dirn, u_act, u_dom)], None, 1, (h, w),
            tile_shape, k, dom, dirs, t_eps, t_eps_mu, (dy % h, dx % w))
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
    _, h, w = grids.shape
    out = torch.empty_like(grids)
    _launch([out], [grids], [(cell, dirn, u_act, u_dom)], [shifts], n,
            (h, w), tile_shape, k, dom, dirs, t_eps, t_eps_mu)
    LAUNCHES["escg_tile_round_trials"] += 1
    return out


# ---------- the table form: K3 over every block of every trial ----------- #

def escg_tile_round_table_plain(sources: Sequence[torch.Tensor],
                                props: Sequence[ProposalBatch],
                                shifts: Sequence[torch.Tensor],
                                block_shape: Tuple[int, int],
                                dom: torch.Tensor,
                                tile_shape: Tuple[int, int], t_eps: float,
                                t_eps_mu: float) -> List[torch.Tensor]:
    """Plain version of K3's table form: the plain K3 of each trial's
    window of each run at its shift."""
    return [torch.stack([
        escg_tile_round_plain(g, *(f[t] for f in pr), dom, tile_shape,
                              t_eps, t_eps_mu)
        for t, g in enumerate(fused.halo_windows(src, sh, block_shape))])
        for src, pr, sh in zip(sources, props, shifts)]


def escg_tile_round_table(sources: Sequence[torch.Tensor],
                          props: Sequence[ProposalBatch],
                          shifts: Sequence[torch.Tensor],
                          block_shape: Tuple[int, int], dom: torch.Tensor,
                          dirs: torch.Tensor, tile_shape: Tuple[int, int],
                          t_eps: float, t_eps_mu: float
                          ) -> List[torch.Tensor]:
    """One sublattice round of every run of a table in one K3 launch: run
    r is the n trials of one block, ``sources[r]`` its (n, sh, sw) cells
    with their halo; trial t reads its window at ``shifts[r][t]`` ((n, 2)
    int64) and plays its (T, K) slice of the (n, T, K) fields of
    ``props[r]``, drawn for the block's global tile ids. Every run lies on
    one device, with ``dom`` and ``dirs``; returns each run's (n, H, W)
    block in the rolled frame."""
    n = fused._check_table(sources, (shifts,), block_shape, tile_shape)
    if len(props) != len(sources) or len(shifts) != len(sources):
        raise ValueError("a table gives every run its proposals and shifts")
    h, w = block_shape
    for pr in props:
        if pr.cell.dim() != 3 or pr.cell.shape[0] != n:
            raise ValueError(f"a run's proposals are ({n}, T, K), got "
                             f"{tuple(pr.cell.shape)}")
        k = _check(sources[0][0, :h, :w], pr.cell[0], pr.dirn[0],
                   pr.u_act[0], pr.u_dom[0], tile_shape)
        for f in pr:
            if f.shape != pr.cell.shape:
                raise ValueError("the proposal fields differ in shape")
    build.check_tables(sources[0], dom, dirs)
    if sources[0].device.type == "cpu":
        return escg_tile_round_table_plain(sources, props, shifts,
                                           block_shape, dom, tile_shape,
                                           t_eps, t_eps_mu)
    outs = [src.new_empty((n, h, w)) for src in sources]
    _launch(outs, list(sources), [tuple(pr) for pr in props], list(shifts),
            n, block_shape, tile_shape, k, dom, dirs, t_eps, t_eps_mu)
    LAUNCHES["escg_tile_round_table"] += 1
    return outs
