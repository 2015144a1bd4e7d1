"""Domain-decomposed ESCG over a device mesh (port of
``repro.core.sharded``, DESIGN.md §5).

The lattice is split into the mesh's R x C contiguous blocks, block (ri,
ci) on ``mesh.devices[ri][ci]`` (:class:`ShardedLattice`); a batch of
trials is split the same way, each block holding its cells of every trial
as an (n, bh, bw) tensor. One round:

1. **halo**: the round's torus shift (dy, dx) in [0, th) x [0, tw) moves
   every block's window by at most ``th`` rows (``tw`` columns) into the
   next block on that mesh axis. Each block is extended once per round by
   a halo shaped by the tile, not by the shift (:func:`halo_extend`): the
   first ``th`` rows of the block below, the first ``tw`` columns of the
   block to the right and the corner of the diagonal one, the reference's
   static ``halo`` slabs of ``halo_roll``. O(halo x perimeter) bytes cross
   between blocks, never the whole lattice. An axis of one block has no
   halo: the shift is a torus roll of the block itself;
2. **local update**: every block of every trial runs the round on its
   window of the extended block at that trial's shift, keyed by global
   tile id (:func:`make_local_round_batch`): K1's table form with each
   block's ``tile_offset`` and the global ``grid_tiles_w`` for
   ``local_kernel='fused'``; ``tile_stream_batch`` of the owned tile ids,
   then K3's table form, for ``'pallas'``; the plain sweep of each trial's
   window for ``'jnp'``. The kernels read the window inside their tile
   load, so one launch per device covers every block of every trial.
   Proposals stay inside tile interiors and blocks are unions of tiles, so
   no block writes another block's cells;
3. the shift is accumulated, not rolled back, as on the single-device
   engines, so the gathered lattice is in their frame.

The counts of every MCS come from ``density_counts_sharded`` (K4s: one
launch over a device's blocks, the devices' partials summed on the mesh's
first device). Because the
streams are keyed by global tile id, a run is bit-identical to the
single-device engine of its family for every mesh: ``sublattice`` for
``'jnp'`` and ``'pallas'``, ``pallas_fused`` for ``'fused'``.

One process drives every block, as ``shard_map`` does for the reference.
A block's launches go to the current stream of its device, in mesh
order; a copy between two devices is ordered on both devices' current
streams by PyTorch, and the gather and the count sum copy to the mesh's
first device the same way. Mesh entries may repeat a device (four
``cuda:0`` entries run the whole decomposition on one card); the code is
the same when they differ. :func:`halo_roll` and :func:`shard_shift2d`
are the reference's shift by slab copies, which the explicit-proposal
round (:func:`sharded_run_round`) uses.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..kernels import ops as kernel_ops
from ..kernels.density import density_counts_sharded
from ..kernels.escg_update_fused import (MAX_RUNS, check_counter_capacity,
                                         halo_windows)
from ..parallel.sharding import LatticeMesh, lattice_mesh
from . import engines, sublattice, threefry
from .lattice import DIRS
from .observables import BlockView
from .rng import ProposalBatch, round_shift, tile_stream_batch

__all__ = ["ShardedLattice", "place", "halo_roll", "shard_shift2d",
           "halo_extend", "round_stream_inputs", "make_local_round_batch",
           "make_local_round", "make_local_multi_round", "sharded_counts",
           "build_engine", "sharded_run_round", "make_sharded_simulation"]

Blocks = Tuple[Tuple[torch.Tensor, ...], ...]


class ShardedLattice(NamedTuple):
    """An (H, W) lattice, or an (n, H, W) batch of trials, split into its
    mesh's R x C contiguous blocks of equal shape, ``blocks[ri][ci]`` on
    ``mesh.devices[ri][ci]``: each block is (bh, bw), or (n, bh, bw) with
    its cells of every trial."""
    mesh: LatticeMesh
    blocks: Blocks

    @property
    def flat(self) -> Tuple[torch.Tensor, ...]:
        """The blocks in raster mesh order."""
        return tuple(b for row in self.blocks for b in row)

    @property
    def device(self) -> torch.device:
        return self.mesh.first

    @property
    def lead(self) -> Tuple[int, ...]:
        """The leading dims of every block: () or (n,)."""
        return tuple(self.blocks[0][0].shape[:-2])

    @property
    def shape(self) -> Tuple[int, int]:
        return (sum(row[0].shape[-2] for row in self.blocks),
                sum(b.shape[-1] for b in self.blocks[0]))

    def gather(self) -> torch.Tensor:
        """The whole (..., H, W) lattice on the mesh's first device."""
        first = self.mesh.first
        return torch.cat([torch.cat([b.to(first) for b in row], dim=-1)
                          for row in self.blocks], dim=-2)

    def views(self) -> List[BlockView]:
        """Each block with its global offset and the one-cell halo the
        bond observables read: the first column of its right neighbour
        and the first row of its lower neighbour on the torus (of every
        trial), copied to the block's device."""
        dr, dc = self.mesh.shape
        bh, bw = self.blocks[0][0].shape[-2:]
        return [BlockView(b, (ri * bh, ci * bw),
                          self.blocks[ri][(ci + 1) % dc][..., :, :1]
                          .to(b.device),
                          self.blocks[(ri + 1) % dr][ci][..., :1, :]
                          .to(b.device))
                for ri, row in enumerate(self.blocks)
                for ci, b in enumerate(row)]


def place(grid: torch.Tensor, mesh: LatticeMesh) -> ShardedLattice:
    """Split an (..., H, W) lattice or trial batch into the mesh's
    contiguous blocks, each on its device (the counterpart of
    ``jax.device_put`` onto ``P('rows', 'cols')``)."""
    h, w = grid.shape[-2:]
    dr, dc = mesh.shape
    if h % dr or w % dc:
        raise ValueError(f"a {dr}x{dc} mesh does not split a {h}x{w} "
                         "lattice into equal blocks")
    bh, bw = h // dr, w // dc
    return ShardedLattice(mesh, tuple(
        tuple(grid[..., ri * bh:(ri + 1) * bh, ci * bw:(ci + 1) * bw]
              .to(mesh.devices[ri][ci]).contiguous() for ci in range(dc))
        for ri in range(dr)))


def _check_blocks(h: int, w: int, mesh: LatticeMesh,
                  tile_shape: Tuple[int, int]) -> None:
    (dr, dc), (th, tw) = mesh.shape, tile_shape
    if h % dr or w % dc or (h // dr) % th or (w // dc) % tw:
        raise ValueError(f"device blocks ({h // dr}x{w // dc}) must be "
                         f"unions of {th}x{tw} tiles")


# ------------------------------- halo copies ------------------------------- #

def halo_roll(blocks: Sequence[torch.Tensor], s: int, halo: int, axis: int,
              reverse: bool = False) -> List[torch.Tensor]:
    """Torus roll of the whole lattice by ``-s`` (``+s`` when ``reverse``)
    along ``axis``, on the ring of ``blocks`` that lie along that mesh
    axis; returns the new blocks, each on its block's device.

    Requires ``0 <= s < halo <= block extent``: the wrapped sliver then
    crosses exactly one block boundary, so a ``halo``-sized slab of the
    next (previous) block suffices. The slab is copied to the block's
    device and the window is sliced out of the block and the slab before
    they are concatenated, so the block is copied once; the window is
    contiguous. With one block on the axis, the block rolls itself.
    """
    n = len(blocks)
    extent = blocks[0].shape[axis]
    s = int(s)
    if not 0 <= s < halo <= extent:
        raise ValueError(f"halo_roll needs 0 <= s < halo <= block extent, "
                         f"got s={s}, halo={halo}, extent={extent}")
    if n == 1:
        return [torch.roll(blocks[0], s if reverse else -s, axis)]
    if s == 0:
        return [b.contiguous() for b in blocks]
    out = []
    for i, local in enumerate(blocks):
        if not reverse:
            # new_local[i] = old[i][s:] ++ old[i + 1][:s]
            slab = blocks[(i + 1) % n].narrow(axis, 0, halo) \
                .to(local.device)
            parts = (local.narrow(axis, s, extent - s),
                     slab.narrow(axis, 0, s))
        else:
            # new_local[i] = old[i - 1][extent - s:] ++ old[i][:extent - s]
            slab = blocks[(i - 1) % n].narrow(axis, extent - halo, halo) \
                .to(local.device)
            parts = (slab.narrow(axis, halo - s, s),
                     local.narrow(axis, 0, extent - s))
        out.append(torch.cat(parts, dim=axis))
    return out


def _roll_rows(blocks: Blocks, s: int, halo: int,
               reverse: bool = False) -> Blocks:
    """``halo_roll`` along axis 0 on every column of the mesh."""
    cols = [halo_roll([row[ci] for row in blocks], s, halo, 0, reverse)
            for ci in range(len(blocks[0]))]
    return tuple(tuple(col[ri] for col in cols)
                 for ri in range(len(blocks)))


def _roll_cols(blocks: Blocks, s: int, halo: int,
               reverse: bool = False) -> Blocks:
    """``halo_roll`` along axis 1 on every row of the mesh."""
    return tuple(tuple(halo_roll(row, s, halo, 1, reverse))
                 for row in blocks)


def shard_shift2d(lattice: ShardedLattice, shift: Sequence[int],
                  tile_shape: Tuple[int, int],
                  reverse: bool = False) -> ShardedLattice:
    """Apply (or, with ``reverse``, undo) the round's 2-D torus shift:
    rows first, then columns, each block's window from its own halo
    copies (``shift`` host integers, ``0 <= shift < tile_shape``)."""
    th, tw = tile_shape
    blocks = _roll_rows(lattice.blocks, int(shift[0]), th, reverse)
    return ShardedLattice(lattice.mesh,
                          _roll_cols(blocks, int(shift[1]), tw, reverse))


def halo_extend(lattice: ShardedLattice,
                tile_shape: Tuple[int, int]) -> Blocks:
    """Every block extended by its halo, on the block's device: on a mesh
    axis of more than one block, the first ``th`` rows of the block below
    (the first ``tw`` columns of the block to the right), and with both
    the corner of the diagonal block, so (..., bh + th, bw + tw) on an R
    x C mesh with R, C > 1. An axis of one block gets no halo, and a (1, 1)
    mesh's block is returned as it is. The window of an extended block at
    a shift (dy, dx) in [0, th) x [0, tw), rows and columns wrapped on an
    axis without a halo, is the block of the lattice rolled by (-dy, -dx),
    the reference's ``shard_shift2d``: rolls of the torus commute."""
    (dr, dc), (th, tw) = lattice.mesh.shape, tile_shape
    blocks = lattice.blocks
    if dr == dc == 1:
        return blocks
    bh, bw = blocks[0][0].shape[-2:]
    out = []
    for ri, row in enumerate(blocks):
        new_row = []
        for ci, b in enumerate(row):
            ext = b.new_empty(b.shape[:-2] + (bh + (th if dr > 1 else 0),
                                              bw + (tw if dc > 1 else 0)))
            ext[..., :bh, :bw] = b
            if dc > 1:
                ext[..., :bh, bw:] = blocks[ri][(ci + 1) % dc][..., :, :tw]
            if dr > 1:
                ext[..., bh:, :bw] = blocks[(ri + 1) % dr][ci][..., :th, :]
            if dr > 1 and dc > 1:
                ext[..., bh:, bw:] = \
                    blocks[(ri + 1) % dr][(ci + 1) % dc][..., :th, :tw]
            new_row.append(ext)
        out.append(tuple(new_row))
    return tuple(out)


# ------------------------------ local round ------------------------------- #

def _local_tile_ids(ri: int, ci: int, block_shape: Tuple[int, int],
                    tile_shape: Tuple[int, int], gw: int,
                    device) -> torch.Tensor:
    """Global raster ids of the tiles block (ri, ci) owns, in the block's
    raster order: ``(ri * lgh + r) * gw + (ci * lgw + c)``."""
    th, tw = tile_shape
    lgh, lgw = block_shape[0] // th, block_shape[1] // tw
    rows = ri * lgh + torch.arange(lgh, dtype=torch.int64, device=device)
    cols = ci * lgw + torch.arange(lgw, dtype=torch.int64, device=device)
    return (rows[:, None] * gw + cols[None, :]).reshape(-1)


def _update_tiles(local: torch.Tensor, props: ProposalBatch,
                  tile_shape: Tuple[int, int], t_eps: float,
                  t_eps_mu: float, dom: torch.Tensor, dirs: torch.Tensor,
                  local_kernel: str = "jnp") -> torch.Tensor:
    """The stream-fed sweep of one block, its proposals in the block's
    raster tile order: K3 for ``'pallas'``, the plain sweep of
    ``sublattice.run_round`` for ``'jnp'``. The two are bit-identical."""
    if local_kernel == "pallas":
        return kernel_ops.escg_round(local, props, (0, 0), dom, dirs,
                                     tile_shape, t_eps, t_eps_mu,
                                     roll_back=False)
    return sublattice.run_round(local, props, (0, 0), tile_shape, t_eps,
                                t_eps_mu, dom, roll_back=False)


def _tables(dom: torch.Tensor, mesh: LatticeMesh):
    """device -> (dominance matrix, direction table) on that device."""
    dirs = torch.as_tensor(DIRS, dtype=torch.int32)
    return {d: (dom.to(d).contiguous(), dirs.to(d)) for d in set(mesh.flat)}


def round_stream_inputs(p, key: torch.Tensor, th: int, tw: int):
    """Per-MCS ``(stream words, shift)`` of ``make_local_round``, derived
    from one engine key exactly as the single-device engine of the same
    family does: the Philox seed words and ``fold_in(key, 1)``'s shift of
    ``pallas_fused`` for ``'fused'``, the proposal key's data and the
    shift of ``sublattice`` for ``'jnp'`` and ``'pallas'``."""
    if p.local_kernel == "fused":
        return engines.fused_round_inputs(key, th, tw)
    return engines.tiled_round_inputs(key, th, tw)


def make_local_round_batch(p, dom: torch.Tensor,
                           meshes: Sequence[LatticeMesh]):
    """``local_round(lattices, words, shifts) -> lattices``: one round of
    every block of every trial of the lattices ``lattices[g]`` (a trial
    batch of n lattices on ``meshes[g]``, one per pod group; all meshes
    of one shape). ``words`` and ``shifts`` are (G * n, 2) int64 on the
    first mesh's first device, group after group, from
    :func:`round_stream_inputs` of each trial's key. Every block is
    extended by its halo (:func:`halo_extend`) and read at each trial's
    own shift by the update: on each device, one launch of K1's table
    form (``'fused'``) or of K3's after the blocks' draws (``'pallas'``)
    for its blocks of every group, up to ``MAX_RUNS`` a launch, or the
    plain sweep of each trial's window (``'jnp'``)."""
    t_eps, t_eps_mu = p.action_thresholds()
    th, tw, n_tiles, k_per, interior = engines._tiled_setup(p)
    gw = p.length // tw
    dr, dc = meshes[0].shape
    bh, bw = p.height // dr, p.length // dc
    lgh, lgw = bh // th, bw // tw
    tables = {}
    for m in meshes:
        tables.update(_tables(dom, m))
    # device -> its (group, ri, ci) blocks, in mesh order
    by_device = {}
    for g, m in enumerate(meshes):
        for ri, row in enumerate(m.devices):
            for ci, d in enumerate(row):
                by_device.setdefault(d, []).append((g, ri, ci))
    if p.local_kernel == "fused":
        check_counter_capacity(n_tiles, k_per)
    else:
        tids = {(ri, ci, d): _local_tile_ids(ri, ci, (bh, bw), (th, tw), gw,
                                             d)
                for d, items in by_device.items() for _, ri, ci in items}

    def update(runs, sources, words, shifts, d):
        dom_d, dirs_d = tables[d]
        if p.local_kernel == "fused":
            return kernel_ops.escg_round_fused_table(
                sources, words, shifts,
                [(ri * lgh, ci * lgw) for _, ri, ci in runs], (bh, bw),
                dom_d, dirs_d, (th, tw), k_per, t_eps, t_eps_mu,
                p.neighbourhood, gw)
        props = [tile_stream_batch(w, tids[ri, ci, d], k_per, interior,
                                   p.neighbourhood)
                 for w, (_, ri, ci) in zip(words, runs)]
        if p.local_kernel == "pallas":
            return kernel_ops.escg_round_table(
                sources, props, shifts, (bh, bw), dom_d, dirs_d, (th, tw),
                t_eps, t_eps_mu)
        return [sublattice.run_round_trials(
            halo_windows(src, sh, (bh, bw)), pr, torch.zeros_like(sh),
            (th, tw), t_eps, t_eps_mu, dom_d)
            for src, pr, sh in zip(sources, props, shifts)]

    def local_round(lattices, words, shifts):
        n = words.shape[0] // len(lattices)
        sources = [halo_extend(lat, (th, tw)) for lat in lattices]
        sched = {}

        def on(g, d):
            """Group g's words and shifts on device d, copied once."""
            if (g, d) not in sched:
                rows = slice(g * n, (g + 1) * n)
                sched[g, d] = (words[rows].to(d), shifts[rows].to(d))
            return sched[g, d]

        out = [[[None] * dc for _ in range(dr)] for _ in lattices]
        for d, items in by_device.items():
            for c in range(0, len(items), MAX_RUNS):
                runs = items[c:c + MAX_RUNS]
                new = update(runs, [sources[g][ri][ci] for g, ri, ci in runs],
                             [on(g, d)[0] for g, _, _ in runs],
                             [on(g, d)[1] for g, _, _ in runs], d)
                for (g, ri, ci), block in zip(runs, new):
                    out[g][ri][ci] = block
        return [ShardedLattice(m, tuple(tuple(row) for row in o))
                for m, o in zip(meshes, out)]
    return local_round


def make_local_round(p, dom: torch.Tensor, mesh: LatticeMesh):
    """``local_round(lattice, stream, shift) -> lattice``: one round of
    every block of one lattice, :func:`make_local_round_batch` over a
    batch of one trial. ``stream`` and ``shift`` are host integers from
    :func:`round_stream_inputs`, copied to the mesh's first device in one
    copy. The one per-block round of the engine and of its multi-MCS
    form."""
    batch = make_local_round_batch(p, dom, (mesh,))

    def local_round(lattice, words, shift):
        sched = torch.tensor([words, shift], dtype=torch.int64).to(
            mesh.first)
        one = ShardedLattice(mesh, tuple(tuple(b[None] for b in row)
                                         for row in lattice.blocks))
        (out,) = batch([one], sched[0:1], sched[1:2])
        return ShardedLattice(mesh, tuple(tuple(b[0] for b in row)
                                          for row in out.blocks))
    return local_round


def sharded_counts(lattice: ShardedLattice, species: int) -> torch.Tensor:
    """Global (S+1,) int32 counts of a decomposed lattice on the mesh's
    first device: one K4s launch per device (``density_counts_sharded``)."""
    return density_counts_sharded(lattice.flat, species)


def make_local_multi_round(p, dom: torch.Tensor, mesh: LatticeMesh):
    """``local_multi(lattice, seeds (K, 2), shifts (K, 2)) -> (lattice,
    counts (K, S+1))``: K fused MCS, with the global counts of every step,
    bit-identical to K ``local_round`` calls.

    * On a (1, 1) mesh the whole lattice is one block: one K2 launch,
      with ``grid_tiles_w`` the global tile width, the roll in the kernel
      and the counts banked by it.
    * On a larger mesh the halo copies cannot live inside a launch: K
      single rounds, each followed by ``density_counts_sharded``. The
      schedule is read to the host once per launch group.
    """
    t_eps, t_eps_mu = p.action_thresholds()
    th, tw, n_tiles, k_per, _ = engines._tiled_setup(p)
    check_counter_capacity(n_tiles, k_per)
    gw = p.length // tw

    if mesh.shape == (1, 1):
        dom_d, dirs_d = _tables(dom, mesh)[mesh.first]

        def local_multi(lattice, seeds, shifts):
            grid, counts = kernel_ops.escg_rounds_fused(
                lattice.blocks[0][0], seeds, shifts, dom_d, dirs_d, (th, tw),
                k_per, t_eps, t_eps_mu, p.species, p.neighbourhood,
                grid_tiles_w=gw)
            return ShardedLattice(mesh, ((grid,),)), counts
        return local_multi

    single = make_local_round(p, dom, mesh)

    def local_multi(lattice, seeds, shifts):
        counts = []
        for seed, shift in zip(seeds.tolist(), shifts.tolist()):
            lattice = single(lattice, seed, shift)
            counts.append(sharded_counts(lattice, p.species))
        if not counts:
            return lattice, torch.zeros((0, p.species + 1),
                                        dtype=torch.int32, device=mesh.first)
        return lattice, torch.stack(counts)
    return local_multi


# ------------------------------- the engine -------------------------------- #

def build_engine(params, dom: torch.Tensor,
                 devices: Optional[Sequence] = None,
                 mesh: Optional[LatticeMesh] = None
                 ) -> engines.BuiltEngine:
    """Build engine ``'sharded'`` for the registry. ``mesh`` defaults to a
    lattice mesh over ``devices`` (``None``: every visible card), shaped
    by ``params.shard_grid`` (chosen by ``auto_shard_grid`` when None)."""
    p = params.validate()
    th, tw, n_tiles, k_per, _ = engines._tiled_setup(p)
    if mesh is None:
        mesh = lattice_mesh(p.shard_grid, p.height, p.length, th, tw,
                            devices)
    _check_blocks(p.height, p.length, mesh, (th, tw))
    dom = torch.as_tensor(dom, dtype=torch.float32).to(mesh.first)
    local_round = make_local_round(p, dom, mesh)
    attempts = torch.tensor(n_tiles * k_per, dtype=torch.int32,
                            device=mesh.first)

    def round_inputs(k1):
        return round_stream_inputs(p, k1, th, tw)

    def schedule(key, n_mcs):
        return engines._round_schedule(key, n_mcs, round_inputs)

    def one_mcs(lattice, stream, shift):
        return local_round(lattice, stream, shift), attempts

    multi_mcs = (make_local_multi_round(p, dom, mesh)
                 if p.local_kernel == "fused" else None)
    return engines.BuiltEngine(
        schedule, one_mcs, attempts_per_mcs=n_tiles * k_per,
        device=mesh.first, multi_mcs=multi_mcs,
        place=lambda grid: place(grid, mesh), gather=ShardedLattice.gather,
        counts=sharded_counts, round_inputs=round_inputs)


# --------------------- explicit-proposal round (tests) -------------------- #

def sharded_run_round(grid, props: ProposalBatch, shift: Sequence[int],
                      tile_shape: Tuple[int, int], t_eps: float,
                      t_eps_mu: float, dom: torch.Tensor, mesh: LatticeMesh,
                      roll_back: bool = True, local_kernel: str = "jnp"):
    """One shifted-window round with proposals given in global raster tile
    order, (T, K); bit-identical to ``sublattice.run_round`` on the same
    inputs. ``grid`` is an (H, W) tensor (the result is gathered on the
    mesh's first device) or a :class:`ShardedLattice` (one is returned)."""
    h, w = grid.shape
    th, tw = tile_shape
    _check_blocks(h, w, mesh, tile_shape)
    shift = tuple(int(v) for v in shift)
    lattice = grid if isinstance(grid, ShardedLattice) else \
        place(grid.to(mesh.first), mesh)
    lattice = shard_shift2d(lattice, shift, tile_shape)
    tables = _tables(dom, mesh)
    out = []
    for ri, row in enumerate(lattice.blocks):
        new_row = []
        for ci, gl in enumerate(row):
            tids = _local_tile_ids(ri, ci, gl.shape, tile_shape, w // tw,
                                   props.cell.device)
            local = ProposalBatch(*(f[tids].to(gl.device) for f in props))
            dom_d, dirs_d = tables[gl.device]
            new_row.append(_update_tiles(gl, local, tile_shape, t_eps,
                                         t_eps_mu, dom_d, dirs_d,
                                         local_kernel))
        out.append(tuple(new_row))
    lattice = ShardedLattice(mesh, tuple(out))
    if roll_back:
        lattice = shard_shift2d(lattice, shift, tile_shape, reverse=True)
    return lattice if isinstance(grid, ShardedLattice) else lattice.gather()


def make_sharded_simulation(params, dom, mesh: LatticeMesh,
                            roll_back: bool = True):
    """``(place, one_mcs)`` on an explicit mesh, the notebook-facing
    wrapper: ``place(grid)`` splits an (H, W) lattice over ``mesh`` and
    ``one_mcs(grid, key) -> grid`` runs one MCS of the ``sublattice``
    schedule through :func:`sharded_run_round` (a lattice of either kind,
    as that function takes).

    Unlike the registered engine, which accumulates the window shift, it
    rolls the lattice back every MCS by default, so snapshots and spatial
    analyses stay in the fixed frame; ``roll_back=False`` is the drifting
    frame."""
    p = params.validate()
    if p.engine not in ("sublattice", "pallas", "sharded"):
        raise ValueError("sharded ESCG uses a tiled engine")
    t_eps, t_eps_mu = p.action_thresholds()
    th, tw, n_tiles, k_per, interior = engines._tiled_setup(p)
    dom_t = torch.as_tensor(dom, dtype=torch.float32).to(mesh.first)
    tile_ids = torch.arange(n_tiles, dtype=torch.int64, device=mesh.first)

    def one_mcs(grid, key):
        kp, ks = threefry.split(key)
        props = tile_stream_batch(kp.to(mesh.first), tile_ids, k_per,
                                  interior, p.neighbourhood)
        return sharded_run_round(grid, props, round_shift(ks, th, tw).tolist(),
                                 (th, tw), t_eps, t_eps_mu, dom_t, mesh,
                                 roll_back=roll_back)

    return (lambda grid: place(grid, mesh)), one_mcs
