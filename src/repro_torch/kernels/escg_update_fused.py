"""Fused-Philox sublattice kernels (port of ``repro.kernels.escg_update_fused``).

Two hand-written CUDA kernels (``csrc/escg_update_fused.cu``) and their
plain PyTorch versions:

* ``escg_tile_round_fused`` (K1): one round over the lattice rolled by
  ``-shift`` (default none; the roll is fused into the kernel's tile
  load). Tile (i, j) derives its K proposals from Philox-4x32-10 with
  counter (global tile id * K + j, round, 0, 0) and key = two seed words,
  and applies them in order to its interior.
* ``escg_tile_rounds_fused`` (K2, the ``k_mcs`` megakernel): K MCS in one
  launch. Step t rolls the torus by ``shifts[t]``, sweeps every tile with
  ``seeds[t]`` at round 0 and banks the species counts in row t. The grid
  stays in the drifted frame.

``tile_offset``/``grid_tiles_w`` key the counters by global tile identity
when the grid is one shard of a larger lattice (DESIGN.md §6).

The trial forms ``escg_tile_round_fused_trials`` and
``escg_tile_rounds_fused_trials`` take a batch of IID trials, n lattices
stacked as one (n, H, W) tensor with each trial's seed words and shifts in
tensors on the card, and run K1 or K2 once for all of them; the trial never
enters a Philox counter, so trial t equals the single-lattice kernel with
its own seeds and shift (the reference vmaps its kernels over trials).
Their plain versions are the single-lattice ones, trial by trial.

The table form ``escg_tile_round_fused_table`` is K1 over every block of
every trial of a card, for a trial batch decomposed over a ('pod', 'rows',
'cols') mesh (``core/sharded_pod.py``): up to ``MAX_RUNS`` runs in one
launch, each one block of one pod group, read from the block extended by a
halo at each trial's own shift (``halo_windows``) and keyed by the block's
offset in the global tile grid. A trial batch is a table of one run and one
lattice a table of one run of one trial: the three forms are one kernel.
Its plain version is the plain trial form on each run's windows.

On the card a block stages up to 32 tiles in shared memory, as int8 where
the labels 0..S fit it (S <= 127) and else in the lattice's type;
``staging`` sizes it and raises for a tile that does not fit.

A wrapper launches its kernel for a CUDA tensor and takes the plain
version only for a CPU tensor. ``LAUNCHES`` counts kernel launches, the
trial forms' under their own names (plain calls are not counted), so a
run can show that it went through the kernels.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from ..core import sublattice
from ..core.rng import ProposalBatch
from ..core.threefry import MASK, mul32
from . import build
from .philox import philox_proposal_fields

LAUNCHES = {"escg_tile_round_fused": 0, "escg_tile_rounds_fused": 0,
            "escg_tile_round_fused_trials": 0,
            "escg_tile_rounds_fused_trials": 0,
            "escg_tile_round_fused_table": 0}

_LIB = "escg_update_fused"
# the shared memory a block may use on the H100 (227 KB), less the kernels'
# static direction table
SMEM_BYTES = 232448 - 64
TILES_PER_BLOCK = 32        # a block is one warp, one tile per lane
MAX_TRIALS = 65535          # trials in one launch (the grid's y extent)
MAX_RUNS = 32               # runs in one table launch (kMaxRuns)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def check_counter_capacity(n_tiles: int, k_per_tile: int) -> None:
    """Guard the c0 counter word: ``tile_id * k_per_tile + j`` is computed
    in uint32, so the global proposal-index space must fit in 2^32 or
    distant tiles silently alias each other's Philox streams."""
    if n_tiles * k_per_tile > 2 ** 32:
        raise ValueError(
            f"fused-Philox counter overflow: {n_tiles} global tiles x "
            f"{k_per_tile} proposals/tile = {n_tiles * k_per_tile} counters "
            f"exceeds the uint32 counter space (2^32); shrink k_per_tile "
            f"or enlarge the tile")


def _geometry(grid: torch.Tensor, tile_shape: Tuple[int, int],
              k_per_tile: int, grid_tiles_w: Optional[int]):
    if grid.dim() != 2:
        raise ValueError(f"grid must be 2-D, got shape {tuple(grid.shape)}")
    if grid.dtype not in build.CELL_DTYPES:
        raise ValueError(f"grid dtype must be int8/int16/int32, got "
                         f"{grid.dtype}")
    h, w = grid.shape
    th, tw = tile_shape
    if th < 3 or tw < 3 or h % th or w % tw:
        raise ValueError(f"tile {tile_shape} must be >= 3x3 and divide "
                         f"the grid {h}x{w}")
    if k_per_tile < 1:
        raise ValueError(f"k_per_tile must be >= 1, got {k_per_tile}")
    gh, gw = h // th, w // tw
    if grid_tiles_w is None:
        # single-lattice call: the local tile grid is the global one;
        # sharded callers guard the true global tile count themselves
        check_counter_capacity(gh * gw, k_per_tile)
        grid_tiles_w = gw
    return h, w, th, tw, gh, gw, int(grid_tiles_w)


def staging(tile_shape: Tuple[int, int], cell_bytes: int, n_dom: int,
            per_tile_bytes: int = 0) -> Tuple[int, int]:
    """``(stage_bytes, tiles_per_block)`` of the kernels' shared-memory
    staging: cells as int8 where labels 0..n_dom-1 fit it, else in the
    lattice's ``cell_bytes``, rows padded to 32-bit words, and as many
    tiles a block as fit beside K2's ``n_dom`` bins, each with
    ``per_tile_bytes`` more beside it (K3's proposal chunks), at most 32.
    Raises ``ValueError`` if not one tile fits."""
    th, tw = tile_shape
    stage = 1 if n_dom <= 128 else cell_bytes
    tile_bytes = 4 * th * -(-tw * stage // 4)
    per_block = (SMEM_BYTES - 4 * n_dom) // (tile_bytes + per_tile_bytes)
    if per_block < 1:
        raise ValueError(
            f"tile {tuple(tile_shape)} staged in {stage}-byte cells takes "
            f"{tile_bytes} bytes of shared memory and {per_tile_bytes} more "
            f"beside it, with {4 * n_dom} for the counts; a block has "
            f"{SMEM_BYTES}: use a smaller tile")
    return stage, min(TILES_PER_BLOCK, per_block)


def _check_tables(grid: torch.Tensor, dom: torch.Tensor,
                  dirs: torch.Tensor, neighbourhood: int) -> None:
    if neighbourhood not in (4, 8):
        raise ValueError("neighbourhood must be 4 or 8")
    build.check_tables(grid, dom, dirs)


def _lib() -> ctypes.CDLL:
    lib = build.load(_LIB)
    fn = lib.escg_tile_round_fused
    if fn.argtypes is None:
        u32, i32, ptr = ctypes.c_uint32, ctypes.c_int, ctypes.c_void_p
        f32 = ctypes.c_float
        fn.argtypes = [i32, i32, i32, i32, ptr, ptr, ptr, ptr, ptr, i32,
                       i32, i32, i32, i32, i32, i32, i32, u32, u32, u32, u32,
                       i32, i32, ptr, i32, ptr, i32, f32, f32, i32, ptr]
        fn.restype = i32
        fn = lib.escg_tile_rounds_fused
        fn.argtypes = [i32, i32, i32, ptr, ptr, ptr, i32, i32, i32, i32,
                       i32, i32, u32, u32, u32, ptr, ptr, i32, ptr, i32, ptr,
                       i32, f32, f32, ptr, i32, ptr]
        fn.restype = i32
        fn = lib.escg_tile_rounds_fused_blocks
        fn.argtypes = [i32, i32, i32, i32, i32, i32, i32]
        fn.restype = i32
    return lib


def cooperative_blocks(grid: torch.Tensor, species: int,
                       tile_shape: Tuple[int, int]) -> int:
    """Blocks the K2 cooperative launch may use on the grid's card."""
    stage, per_block = staging(tile_shape, grid.element_size(), species + 1)
    device, _ = build.launch_args(grid)
    return _lib().escg_tile_rounds_fused_blocks(
        grid.element_size(), stage, per_block, *tile_shape, species + 1,
        device)


def _ptrs(tensors) -> ctypes.Array:
    """A host array of the tensors' data pointers (a C ``void**``)."""
    return (ctypes.c_void_p * len(tensors))(
        *(build.ptr(t).value for t in tensors))


def _launch_round(outs, ins, seeds, shifts, offsets, n: int,
                  block_shape: Tuple[int, int], tile_shape: Tuple[int, int],
                  k_per_tile: int, grid_tiles_w: int, dom: torch.Tensor,
                  dirs: torch.Tensor, neighbourhood: int, t_eps: float,
                  t_eps_mu: float, round_idx: int = 0,
                  seed: Tuple[int, int] = (0, 0),
                  shift: Tuple[int, int] = (0, 0)) -> None:
    """One K1 launch over the runs ``ins[r]`` -> ``outs[r]`` (each n stacked
    lattices of ``block_shape`` cells, read from sources of the shape of
    ``ins[r]``'s last two dims), with the runs' (n, 2) ``seeds``/``shifts``
    on the card, or ``None`` for one lattice with the scalar ``seed`` and
    ``shift``."""
    first = ins[0]
    h, w = block_shape
    sh, sw = first.shape[-2:]
    th, tw = tile_shape
    stage, per_block = staging(tile_shape, first.element_size(),
                               dom.shape[0])
    device, stream = build.launch_args(first)
    offs = (ctypes.c_uint32 * (2 * len(ins)))(
        *(int(v) & MASK for off in offsets for v in off))
    lib = _lib()
    err = lib.escg_tile_round_fused(
        first.element_size(), stage, per_block, len(ins), _ptrs(outs),
        _ptrs(ins), None if seeds is None else _ptrs(seeds),
        None if shifts is None else _ptrs(shifts), offs, n, h, w, sh, sw,
        th, tw, int(k_per_tile), int(grid_tiles_w) & MASK,
        int(seed[0]) & MASK, int(seed[1]) & MASK, int(round_idx) & MASK,
        int(shift[0]), int(shift[1]), build.ptr(dom), dom.shape[0],
        build.ptr(dirs), int(neighbourhood), float(t_eps), float(t_eps_mu),
        device, stream)
    build.check(lib, err, "escg_tile_round_fused launch")


# ----------------------------- K1: one round ------------------------------ #

def escg_tile_round_fused_plain(grid: torch.Tensor, seed: Tuple[int, int],
                                round_idx: int, dom: torch.Tensor,
                                tile_shape: Tuple[int, int], k_per_tile: int,
                                t_eps: float, t_eps_mu: float,
                                neighbourhood: int = 4,
                                tile_offset: Tuple[int, int] = (0, 0),
                                grid_tiles_w: Optional[int] = None,
                                shift: Tuple[int, int] = (0, 0)
                                ) -> torch.Tensor:
    """Plain version of K1 (same function, any device): the roll by
    ``-shift``, Philox fields for every (tile, proposal), then the tile
    sweep of ``core.sublattice``."""
    h, w, th, tw, gh, gw, gtw = _geometry(grid, tile_shape, k_per_tile,
                                          grid_tiles_w)
    if shift[0] or shift[1]:
        grid = torch.roll(grid, (-int(shift[0]), -int(shift[1])), (0, 1))
    dev = grid.device
    ti = torch.arange(gh, dtype=torch.int64, device=dev)[:, None]
    tj = torch.arange(gw, dtype=torch.int64, device=dev)[None, :]
    tile_id = (mul32((int(tile_offset[0]) + ti) & MASK, gtw)
               + int(tile_offset[1]) + tj) & MASK
    j = torch.arange(k_per_tile, dtype=torch.int64, device=dev)
    idx = (mul32(tile_id.reshape(-1, 1), k_per_tile) + j) & MASK
    props = ProposalBatch(*philox_proposal_fields(
        idx, round_idx, seed[0], seed[1], (th - 2) * (tw - 2),
        neighbourhood))
    tiles = sublattice.tile_update(sublattice.to_tiles(grid, th, tw), props,
                                   t_eps, t_eps_mu, dom)
    return sublattice.from_tiles(tiles, h, w)


def escg_tile_round_fused(grid: torch.Tensor, seed: Tuple[int, int],
                          round_idx: int, dom: torch.Tensor,
                          dirs: torch.Tensor, tile_shape: Tuple[int, int],
                          k_per_tile: int, t_eps: float, t_eps_mu: float,
                          neighbourhood: int = 4,
                          tile_offset: Tuple[int, int] = (0, 0),
                          grid_tiles_w: Optional[int] = None,
                          shift: Tuple[int, int] = (0, 0)
                          ) -> torch.Tensor:
    """One fused round over the (H, W) grid rolled by ``-shift`` (the
    kernel reads the rolled cells; the default leaves the grid as it is);
    returns a new grid in the rolled frame. ``seed``: two uint32 key
    words; ``round_idx``: the uint32 counter word c1. ``dom``: padded
    (S+1, S+1) float32 dominance matrix and ``dirs`` the (8, 2) int32
    direction table, both on the grid's device.
    """
    h, w, th, tw, gh, gw, gtw = _geometry(grid, tile_shape, k_per_tile,
                                          grid_tiles_w)
    _check_tables(grid, dom, dirs, neighbourhood)
    if grid.device.type == "cpu":
        return escg_tile_round_fused_plain(
            grid, seed, round_idx, dom, tile_shape, k_per_tile, t_eps,
            t_eps_mu, neighbourhood, tile_offset, grid_tiles_w, shift)
    out = torch.empty_like(grid)
    _launch_round([out], [grid], None, None, [tuple(tile_offset)], 1,
                  (h, w), tile_shape, k_per_tile, gtw, dom, dirs,
                  neighbourhood, t_eps, t_eps_mu, round_idx, seed,
                  (int(shift[0]) % h, int(shift[1]) % w))
    LAUNCHES["escg_tile_round_fused"] += 1
    return out


# ------------------------ K2: K rounds per launch ------------------------- #

def escg_tile_rounds_fused_plain(grid: torch.Tensor, seeds: torch.Tensor,
                                 shifts: torch.Tensor, dom: torch.Tensor,
                                 tile_shape: Tuple[int, int],
                                 k_per_tile: int, t_eps: float,
                                 t_eps_mu: float, species: int,
                                 neighbourhood: int = 4,
                                 tile_offset: Tuple[int, int] = (0, 0),
                                 grid_tiles_w: Optional[int] = None):
    """Plain version of K2: K times (roll, plain K1 at round 0, count)."""
    counts = []
    for (s0, s1), (dy, dx) in zip(seeds.tolist(), shifts.tolist()):
        grid = torch.roll(grid, (-dy, -dx), (0, 1))
        grid = escg_tile_round_fused_plain(
            grid, (s0, s1), 0, dom, tile_shape, k_per_tile, t_eps, t_eps_mu,
            neighbourhood, tile_offset, grid_tiles_w)
        counts.append(torch.bincount(grid.reshape(-1).long(),
                                     minlength=species + 1)[:species + 1])
    if not counts:
        return grid, torch.zeros((0, species + 1), dtype=torch.int32,
                                 device=grid.device)
    return grid, torch.stack(counts).to(torch.int32)


def escg_tile_rounds_fused(grid: torch.Tensor, seeds: torch.Tensor,
                           shifts: torch.Tensor, dom: torch.Tensor,
                           dirs: torch.Tensor, tile_shape: Tuple[int, int],
                           k_per_tile: int, t_eps: float, t_eps_mu: float,
                           species: int, neighbourhood: int = 4,
                           tile_offset: Tuple[int, int] = (0, 0),
                           grid_tiles_w: Optional[int] = None):
    """K fused MCS in one launch. ``seeds``/``shifts``: (K, 2) int64
    tensors on the grid's device, the per-MCS key words and torus shifts
    of ``engines.multi_round_inputs``. Returns ``(grid, counts)`` with
    counts (K, species + 1) int32, ``counts[t]`` the species counts after
    step t."""
    h, w, th, tw, gh, gw, gtw = _geometry(grid, tile_shape, k_per_tile,
                                          grid_tiles_w)
    _check_tables(grid, dom, dirs, neighbourhood)
    if dom.shape[0] != species + 1:
        raise ValueError(f"dom is {tuple(dom.shape)} for {species} species")
    n_steps = seeds.shape[0] if seeds.dim() == 2 else -1
    for name, t in (("seeds", seeds), ("shifts", shifts)):
        if t.dtype != torch.int64 or tuple(t.shape) != (n_steps, 2) \
                or t.device != grid.device:
            raise ValueError(f"{name} must be (K, 2) int64 on "
                             f"{grid.device}, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
    if grid.device.type == "cpu":
        return escg_tile_rounds_fused_plain(
            grid, seeds, shifts, dom, tile_shape, k_per_tile, t_eps,
            t_eps_mu, species, neighbourhood, tile_offset, grid_tiles_w)
    stage, per_block = staging(tile_shape, grid.element_size(), species + 1)
    device, stream = build.launch_args(grid)
    out = torch.empty_like(grid)
    scratch = torch.empty_like(grid)
    counts = torch.empty((n_steps, species + 1), dtype=torch.int32,
                         device=grid.device)
    if n_steps == 0:
        return grid.clone(), counts
    lib = _lib()
    err = lib.escg_tile_rounds_fused(
        grid.element_size(), stage, per_block, build.ptr(out),
        build.ptr(scratch), build.ptr(grid), 1, h, w, th, tw,
        int(k_per_tile), gtw & MASK,
        int(tile_offset[0]) & MASK, int(tile_offset[1]) & MASK,
        build.ptr(seeds), build.ptr(shifts), n_steps, build.ptr(dom),
        dom.shape[0], build.ptr(dirs), int(neighbourhood), float(t_eps),
        float(t_eps_mu), build.ptr(counts), device, stream)
    build.check(lib, err, "escg_tile_rounds_fused cooperative launch")
    LAUNCHES["escg_tile_rounds_fused"] += 1
    return out, counts


# ------------------ the trial forms: K1 and K2 per batch ------------------- #

def _check_trials(grids: torch.Tensor, tile_shape: Tuple[int, int],
                  k_per_tile: int, tensors, lead: Tuple[int, ...]) -> int:
    """Validate a trial batch (n, H, W) and its (n, *lead, 2) int64 tensors
    on the grids' device; returns n."""
    if grids.dim() != 3 or grids.shape[0] < 1:
        raise ValueError(f"a trial batch is (n, H, W), got shape "
                         f"{tuple(grids.shape)}")
    if grids.shape[0] > MAX_TRIALS:
        raise ValueError(f"{grids.shape[0]} trials in one launch; at most "
                         f"{MAX_TRIALS}")
    _geometry(grids[0], tile_shape, k_per_tile, None)
    n = grids.shape[0]
    for name, t in tensors:
        want = (n,) + lead + (2,)
        if t.dtype != torch.int64 or tuple(t.shape) != want \
                or t.device != grids.device:
            raise ValueError(f"{name} must be {want} int64 on "
                             f"{grids.device}, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
    return n


def escg_tile_round_fused_trials_plain(grids: torch.Tensor,
                                       seeds: torch.Tensor,
                                       shifts: torch.Tensor,
                                       dom: torch.Tensor,
                                       tile_shape: Tuple[int, int],
                                       k_per_tile: int, t_eps: float,
                                       t_eps_mu: float,
                                       neighbourhood: int = 4,
                                       round_idx: int = 0,
                                       tile_offset: Tuple[int, int] = (0, 0),
                                       grid_tiles_w: Optional[int] = None
                                       ) -> torch.Tensor:
    """Plain version of K1 over trials: the plain K1 of each trial with its
    seed words and shift."""
    return torch.stack([
        escg_tile_round_fused_plain(g, tuple(s), round_idx, dom, tile_shape,
                                    k_per_tile, t_eps, t_eps_mu,
                                    neighbourhood, tile_offset, grid_tiles_w,
                                    tuple(sh))
        for g, s, sh in zip(grids, seeds.tolist(), shifts.tolist())])


def escg_tile_round_fused_trials(grids: torch.Tensor, seeds: torch.Tensor,
                                 shifts: torch.Tensor, dom: torch.Tensor,
                                 dirs: torch.Tensor,
                                 tile_shape: Tuple[int, int],
                                 k_per_tile: int, t_eps: float,
                                 t_eps_mu: float, neighbourhood: int = 4,
                                 round_idx: int = 0) -> torch.Tensor:
    """One fused round of every trial of the (n, H, W) batch in one K1
    launch: trial t reads its lattice rolled by ``-shifts[t]`` and draws
    with the seed words ``seeds[t]`` (both (n, 2) int64 on the grids'
    device); returns the new batch in the rolled frames."""
    n = _check_trials(grids, tile_shape, k_per_tile,
                      (("seeds", seeds), ("shifts", shifts)), ())
    _check_tables(grids, dom, dirs, neighbourhood)
    if grids.device.type == "cpu":
        return escg_tile_round_fused_trials_plain(
            grids, seeds, shifts, dom, tile_shape, k_per_tile, t_eps,
            t_eps_mu, neighbourhood, round_idx)
    _, h, w = grids.shape
    out = torch.empty_like(grids)
    _launch_round([out], [grids], [seeds], [shifts], [(0, 0)], n, (h, w),
                  tile_shape, k_per_tile, w // tile_shape[1], dom, dirs,
                  neighbourhood, t_eps, t_eps_mu, round_idx)
    LAUNCHES["escg_tile_round_fused_trials"] += 1
    return out


# ------------- the table form: K1 over every block of a card -------------- #

def halo_windows(source: torch.Tensor, shifts: torch.Tensor,
                 block_shape: Tuple[int, int]) -> torch.Tensor:
    """Each trial's window of a run's (n, sh, sw) source at its shift
    ((n, 2) int64, taken modulo the block): ``out[t, r, c] = source[t, (r
    + dy) % sh, (c + dx) % sw]`` for r, c inside the block, as the kernels
    read it. On an axis with a halo (the source longer than the block by a
    tile) a shift below the tile reads within the source; on an axis
    without one it is the torus's roll."""
    n, sh, sw = source.shape
    h, w = block_shape
    dev = source.device
    d = shifts.to(device=dev, dtype=torch.int64) % torch.tensor(
        [h, w], device=dev)
    rows = (torch.arange(h, device=dev)[None, :] + d[:, :1]) % sh
    cols = (torch.arange(w, device=dev)[None, :] + d[:, 1:]) % sw
    idx = (rows[:, :, None] * sw + cols[:, None, :]).reshape(n, -1)
    return torch.gather(source.reshape(n, -1), 1, idx).reshape(n, h, w)


def _check_table(sources: Sequence[torch.Tensor],
                 schedules: Sequence[Sequence[torch.Tensor]],
                 block_shape: Tuple[int, int],
                 tile_shape: Tuple[int, int]) -> int:
    """Validate a table's runs, all on one device: (n, sh, sw) sources of
    one type with sh the block's height or that plus a tile (a halo),
    likewise sw, and each run's (n, 2) int64 tensors; returns n."""
    if not 1 <= len(sources) <= MAX_RUNS:
        raise ValueError(f"a table holds 1 to {MAX_RUNS} runs, got "
                         f"{len(sources)}")
    first = sources[0]
    (h, w), (th, tw) = block_shape, tile_shape
    n = first.shape[0] if first.dim() == 3 else 0
    if not 1 <= n or len(sources) * n > MAX_TRIALS:
        raise ValueError(f"a run is (n, sh, sw) with 1 <= runs x n <= "
                         f"{MAX_TRIALS}, got {tuple(first.shape)}")
    if first.shape[1] not in (h, h + th) or first.shape[2] not in (w, w + tw):
        raise ValueError(f"a source of a {h}x{w} block is its cells or "
                         f"those and a halo of a {th}x{tw} tile, got "
                         f"{tuple(first.shape[1:])}")
    if first.dtype not in build.CELL_DTYPES:
        raise ValueError(f"cells must be int8/int16/int32, got "
                         f"{first.dtype}")
    if th < 3 or tw < 3 or h % th or w % tw:
        raise ValueError(f"tile {tuple(tile_shape)} must be >= 3x3 and "
                         f"divide the block {h}x{w}")
    for src in sources:
        if src.shape != first.shape or src.dtype != first.dtype \
                or src.device != first.device:
            raise ValueError(f"the runs differ: {tuple(src.shape)} "
                             f"{src.dtype} on {src.device} beside "
                             f"{tuple(first.shape)} {first.dtype} on "
                             f"{first.device}")
    for tensors in schedules:
        for t in tensors:
            if t.dtype != torch.int64 or tuple(t.shape) != (n, 2) \
                    or t.device != first.device:
                raise ValueError(f"a run's seeds and shifts are ({n}, 2) "
                                 f"int64 on {first.device}, got "
                                 f"{tuple(t.shape)} {t.dtype} on "
                                 f"{t.device}")
    return n


def escg_tile_round_fused_table_plain(
        sources: Sequence[torch.Tensor], seeds: Sequence[torch.Tensor],
        shifts: Sequence[torch.Tensor],
        tile_offsets: Sequence[Tuple[int, int]],
        block_shape: Tuple[int, int], dom: torch.Tensor,
        tile_shape: Tuple[int, int], k_per_tile: int, t_eps: float,
        t_eps_mu: float, neighbourhood: int, grid_tiles_w: int,
        round_idx: int = 0) -> List[torch.Tensor]:
    """Plain version of K1's table form: the plain K1 over trials of each
    run's windows at their shifts, keyed by the run's tile offset."""
    return [escg_tile_round_fused_trials_plain(
        halo_windows(src, sh, block_shape), s, torch.zeros_like(sh), dom,
        tile_shape, k_per_tile, t_eps, t_eps_mu, neighbourhood, round_idx,
        off, grid_tiles_w)
        for src, s, sh, off in zip(sources, seeds, shifts, tile_offsets)]


def escg_tile_round_fused_table(
        sources: Sequence[torch.Tensor], seeds: Sequence[torch.Tensor],
        shifts: Sequence[torch.Tensor],
        tile_offsets: Sequence[Tuple[int, int]],
        block_shape: Tuple[int, int], dom: torch.Tensor, dirs: torch.Tensor,
        tile_shape: Tuple[int, int], k_per_tile: int, t_eps: float,
        t_eps_mu: float, neighbourhood: int, grid_tiles_w: int,
        round_idx: int = 0) -> List[torch.Tensor]:
    """One fused round of every run of a table in one K1 launch: run r is
    the n trials of one block, ``sources[r]`` its (n, sh, sw) cells with
    their halo, and trial t reads its window at ``shifts[r][t]`` with the
    seed words ``seeds[r][t]`` (both (n, 2) int64), its tiles keyed by
    ``tile_offsets[r]`` in a global grid ``grid_tiles_w`` tiles wide.
    Every run lies on one device, with ``dom`` and ``dirs``; returns each
    run's (n, H, W) block in the rolled frame. The caller guards the
    global counter space (``check_counter_capacity``)."""
    n = _check_table(sources, (seeds, shifts), block_shape, tile_shape)
    if len(seeds) != len(sources) or len(shifts) != len(sources) \
            or len(tile_offsets) != len(sources):
        raise ValueError("a table gives every run its seeds, shifts and "
                         "tile offset")
    _check_tables(sources[0], dom, dirs, neighbourhood)
    if sources[0].device.type == "cpu":
        return escg_tile_round_fused_table_plain(
            sources, seeds, shifts, tile_offsets, block_shape, dom,
            tile_shape, k_per_tile, t_eps, t_eps_mu, neighbourhood,
            grid_tiles_w, round_idx)
    outs = [src.new_empty((n,) + tuple(block_shape)) for src in sources]
    _launch_round(outs, list(sources), list(seeds), list(shifts),
                  tile_offsets, n, block_shape, tile_shape, k_per_tile,
                  grid_tiles_w, dom, dirs, neighbourhood, t_eps, t_eps_mu,
                  round_idx)
    LAUNCHES["escg_tile_round_fused_table"] += 1
    return outs


def escg_tile_rounds_fused_trials_plain(grids: torch.Tensor,
                                        seeds: torch.Tensor,
                                        shifts: torch.Tensor,
                                        dom: torch.Tensor,
                                        tile_shape: Tuple[int, int],
                                        k_per_tile: int, t_eps: float,
                                        t_eps_mu: float, species: int,
                                        neighbourhood: int = 4):
    """Plain version of K2 over trials: the plain K2 of each trial."""
    runs = [escg_tile_rounds_fused_plain(g, s, sh, dom, tile_shape,
                                         k_per_tile, t_eps, t_eps_mu,
                                         species, neighbourhood)
            for g, s, sh in zip(grids, seeds, shifts)]
    return (torch.stack([g for g, _ in runs]),
            torch.stack([c for _, c in runs]))


def escg_tile_rounds_fused_trials(grids: torch.Tensor, seeds: torch.Tensor,
                                  shifts: torch.Tensor, dom: torch.Tensor,
                                  dirs: torch.Tensor,
                                  tile_shape: Tuple[int, int],
                                  k_per_tile: int, t_eps: float,
                                  t_eps_mu: float, species: int,
                                  neighbourhood: int = 4):
    """K fused MCS of every trial of the (n, H, W) batch in one K2 launch.
    ``seeds``/``shifts``: (n, K, 2) int64 on the grids' device, each
    trial's rows of ``engines.multi_round_inputs``. Returns ``(grids,
    counts)`` with counts (n, K, species + 1) int32."""
    k_steps = seeds.shape[1] if seeds.dim() == 3 else -1
    n = _check_trials(grids, tile_shape, k_per_tile,
                      (("seeds", seeds), ("shifts", shifts)), (k_steps,))
    _check_tables(grids, dom, dirs, neighbourhood)
    if dom.shape[0] != species + 1:
        raise ValueError(f"dom is {tuple(dom.shape)} for {species} species")
    if grids.device.type == "cpu":
        return escg_tile_rounds_fused_trials_plain(
            grids, seeds, shifts, dom, tile_shape, k_per_tile, t_eps,
            t_eps_mu, species, neighbourhood)
    _, h, w = grids.shape
    th, tw = tile_shape
    stage, per_block = staging(tile_shape, grids.element_size(), species + 1)
    device, stream = build.launch_args(grids)
    counts = torch.empty((n, k_steps, species + 1), dtype=torch.int32,
                         device=grids.device)
    if k_steps == 0:
        return grids.clone(), counts
    out = torch.empty_like(grids)
    scratch = torch.empty_like(grids)
    lib = _lib()
    err = lib.escg_tile_rounds_fused(
        grids.element_size(), stage, per_block, build.ptr(out),
        build.ptr(scratch), build.ptr(grids), n, h, w, th, tw,
        int(k_per_tile), (w // tw) & MASK, 0, 0, build.ptr(seeds),
        build.ptr(shifts), k_steps, build.ptr(dom), dom.shape[0],
        build.ptr(dirs), int(neighbourhood), float(t_eps), float(t_eps_mu),
        build.ptr(counts), device, stream)
    build.check(lib, err, "escg_tile_rounds_fused_trials cooperative launch")
    LAUNCHES["escg_tile_rounds_fused_trials"] += 1
    return out, counts
