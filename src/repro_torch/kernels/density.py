"""Species histogram kernel (port of ``repro.kernels.density``).

K4, ``density_counts``: the counts of labels 0..S over an (H, W) lattice,
(S+1,) int32; labels outside 0..S are not counted. The CUDA kernel is
``density_kernel`` in ``csrc/density.cu``: one launch of 16-byte loads,
counts in registers (shared-memory bins above 16 labels), each block's
sums added into a scratch buffer that the last block moves into the
output; integer sums, so exact. Its plain version is the reference's
one-hot sum.

K4s, ``density_counts_sharded``: the count of a lattice split into
blocks over a device mesh (the reference lifts K4 into a ``shard_map``
and ``psum``s the partials). The blocks are grouped by device in mesh
order, and each device counts its blocks in one launch (up to
``MAX_GROUP`` blocks a launch, the blocks' pointers passed by value, one
slice of the grid per block, one scratch and one ticket for all); more
blocks on a device make more launches, whose counts are summed there. Only
a mesh over several devices copies its partials to the first device and
sums them in int32. Its plain twin is ``density_counts_plain`` of the
gathered lattice.

K4 per trial, ``density_counts_trials``: the counts of each lattice of a
batch of IID trials stacked as one (n, ...) tensor, (n, S+1) int32, in one
launch: one slice of the grid per trial, each with its own accumulators and
ticket in a scratch that grows with the batch. Its plain version is K4's,
trial by trial.

K4s per trial, ``density_counts_sharded_trials``: each trial's counts of a
trial batch decomposed over a ('pod', 'rows', 'cols') mesh (the reference
vmaps K4s over the trials of each pod group), one launch per device for
every block of every pod group there, a ticket per (group, trial); where a
group's blocks lie on several devices, their partials are summed in int32.
Its plain version is K4 of each trial's gathered cells.

All four are one kernel, ``density_kernel`` in ``csrc/density.cu``: a
table of runs of stacked lattices, the runs of a slot summed per trial.
The wrappers launch the kernels for CUDA tensors and take the plain
versions only for CPU tensors. ``LAUNCHES`` counts kernel launches, the
per-trial form's under its own name.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from . import build

LAUNCHES = {"density_counts": 0, "density_counts_sharded": 0,
            "density_counts_trials": 0, "density_counts_sharded_trials": 0}

_LIB = "density"
MAX_LABELS = 4096      # the bins live in a block's shared memory
MAX_GROUP = 32         # runs in one launch (kMaxGroup of the source)
MAX_TRIALS = 65535     # trials in one per-trial launch (the grid's y extent)

# (device, stream) -> that stream's scratch: the tickets and accumulators
# of a launch (a ticket and S+1 words for each of its count rows), zero
# between launches (each launch's last blocks zero them
# again). Launches on one stream run in order, so they share it; a batch
# that outgrows it replaces it with a larger zero buffer (the stream's
# order keeps the old one alive until its last launch is done).
_SCRATCH: Dict[Tuple[int, int], torch.Tensor] = {}
# the ctypes array types of a launch's run pointers and slots, by run count
_PTR_ARRAYS = [ctypes.c_void_p * n for n in range(MAX_GROUP + 1)]
_SLOT_ARRAYS = [ctypes.c_int * n for n in range(MAX_GROUP + 1)]


def _lib() -> ctypes.CDLL:
    lib = build.load(_LIB)
    fn = lib.density_counts
    if fn.argtypes is None:
        i32, ptr = ctypes.c_int, ctypes.c_void_p
        fn.argtypes = [i32, ptr, ptr, i32, i32, ctypes.c_int64, i32, ptr,
                       ptr, i32, ptr]
        fn.restype = i32
    return lib


def _scratch(grid: torch.Tensor, device: int, stream: ctypes.c_void_p,
             words: int) -> torch.Tensor:
    """The scratch of the launch's stream, at least ``words`` long, made
    zero at its first use."""
    key = (device, stream.value or 0)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < words:
        buf = _SCRATCH[key] = torch.zeros(max(words, 1 + MAX_LABELS),
                                          dtype=torch.int32,
                                          device=grid.device)
    return buf


def _launch(runs: Sequence[torch.Tensor], n_trials: int, species: int,
            out: torch.Tensor, slots: Optional[Sequence[int]] = None,
            what: str = "density_counts") -> None:
    """One launch counting the runs (each ``n_trials`` equal contiguous
    lattices stacked, all on one device) into ``out`` ((n_slots *
    n_trials, S+1) int32, or (S+1,) for one row): row ``slot * n_trials +
    t`` sums trial t of the runs of that slot (``slots=None``: every run
    in slot 0)."""
    first = runs[0]
    device, stream = build.launch_args(first)
    scratch = _scratch(first, device, stream,
                       out.numel() // (species + 1) * (species + 2))
    # K4 runs some hundreds of times per run of a path, so the host work of
    # a launch is kept small: the runs are contiguous (_check_grid) and out
    # and scratch are made here, so their data pointers go in as they are,
    # and the pointer arrays' types are made once
    n_runs = len(runs)
    ptrs = _PTR_ARRAYS[n_runs](*[r.data_ptr() for r in runs])
    lib = _lib()
    err = lib.density_counts(
        first.element_size(), ptrs,
        None if slots is None else _SLOT_ARRAYS[n_runs](*slots), n_runs,
        n_trials, first.numel() // n_trials, species + 1, out.data_ptr(),
        scratch.data_ptr(), device, stream)
    if err:
        build.check(lib, err, f"{what} launch")


def density_counts_plain(grid: torch.Tensor, species: int) -> torch.Tensor:
    """Plain version of K4 (any device): the one-hot of every cell over
    labels 0..S, summed."""
    labels = torch.arange(species + 1, device=grid.device)
    return (grid.reshape(-1, 1) == labels).sum(dim=0, dtype=torch.int32)


def _check_grid(grid: torch.Tensor, species: int) -> None:
    if grid.dtype not in build.CELL_DTYPES:
        raise ValueError(f"grid dtype must be int8/int16/int32, got "
                         f"{grid.dtype}")
    if not grid.is_contiguous():
        raise ValueError("density_counts takes a contiguous grid")
    if not 0 <= species < MAX_LABELS:
        raise ValueError(f"species must be in [0, {MAX_LABELS}), got "
                         f"{species}")


def density_counts(grid: torch.Tensor, species: int) -> torch.Tensor:
    """Counts per label 0..S of a contiguous int8/int16/int32 lattice
    (any shape; a view that starts inside its storage is fine), (S+1,)
    int32 on the grid's device."""
    _check_grid(grid, species)
    if grid.device.type == "cpu":
        return density_counts_plain(grid, species)
    out = torch.empty(species + 1, dtype=torch.int32, device=grid.device)
    _launch([grid], 1, species, out)
    LAUNCHES["density_counts"] += 1
    return out


def _grouped_counts(blocks: Sequence[torch.Tensor],
                    species: int) -> torch.Tensor:
    """(S+1,) int32 counts of up to ``MAX_GROUP`` equal blocks on one
    device: one K4s launch on a card; on the CPU each block's count (K4's
    plain version), summed."""
    first = blocks[0]
    if first.device.type == "cpu":
        return torch.stack([density_counts(b, species)
                            for b in blocks]).sum(dim=0, dtype=torch.int32)
    out = torch.empty(species + 1, dtype=torch.int32, device=first.device)
    _launch(blocks, 1, species, out, what="density_counts_sharded")
    LAUNCHES["density_counts_sharded"] += 1
    return out


def density_counts_sharded(blocks: Sequence[torch.Tensor],
                           species: int) -> torch.Tensor:
    """Counts per label 0..S of a lattice decomposed into ``blocks`` (the
    mesh's blocks in raster order, equal in size and type, each
    contiguous on its own device), (S+1,) int32 on the first block's
    device. Integer sums do not depend on their order, so this equals K4
    of the gathered lattice.

    The blocks of a device are counted in groups of up to ``MAX_GROUP``,
    one K4s launch each on the device's current stream (sharing that
    stream's scratch with K4); a device with more groups sums their
    counts there. A copy of a partial between two cards waits for it on
    its card's stream (PyTorch orders a copy between devices on both
    devices' current streams)."""
    if not blocks:
        raise ValueError("density_counts_sharded takes at least one block")
    for b in blocks:
        _check_grid(b, species)
        if b.dtype != blocks[0].dtype or b.numel() != blocks[0].numel():
            raise ValueError(f"the blocks must be equal in size and type, "
                             f"got {tuple(b.shape)} {b.dtype} beside "
                             f"{tuple(blocks[0].shape)} {blocks[0].dtype}")
    by_device: Dict[torch.device, List[torch.Tensor]] = {}
    for b in blocks:
        by_device.setdefault(b.device, []).append(b)
    parts = [_grouped_counts(bs[g:g + MAX_GROUP], species)
             for bs in by_device.values()
             for g in range(0, len(bs), MAX_GROUP)]
    if len(parts) == 1:
        return parts[0]
    dest = blocks[0].device
    return torch.stack([p.to(dest) for p in parts]).sum(dim=0,
                                                        dtype=torch.int32)


def density_counts_trials_plain(grids: torch.Tensor,
                                species: int) -> torch.Tensor:
    """Plain version of K4 per trial: K4's plain version of each trial."""
    return torch.stack([density_counts_plain(g, species) for g in grids])


def density_counts_trials(grids: torch.Tensor, species: int) -> torch.Tensor:
    """Counts per label 0..S of each lattice of a contiguous (n, ...)
    int8/int16/int32 trial batch, (n, S+1) int32 on the grids' device: one
    launch for every trial on a card."""
    _check_grid(grids, species)
    if grids.dim() < 2 or not 1 <= grids.shape[0] <= MAX_TRIALS:
        raise ValueError(f"a trial batch is (n, ...) with 1 <= n <= "
                         f"{MAX_TRIALS}, got {tuple(grids.shape)}")
    if grids.device.type == "cpu":
        return density_counts_trials_plain(grids, species)
    out = torch.empty((grids.shape[0], species + 1), dtype=torch.int32,
                      device=grids.device)
    _launch([grids], grids.shape[0], species, out,
            what="density_counts_trials")
    LAUNCHES["density_counts_trials"] += 1
    return out


def density_counts_sharded_trials_plain(
        groups: Sequence[Sequence[torch.Tensor]],
        species: int) -> torch.Tensor:
    """Plain version of K4s per trial: K4's plain version of each trial's
    cells gathered from its group's blocks, on the first block's device."""
    dest = groups[0][0].device
    return torch.stack([
        density_counts_plain(torch.cat([b[t].reshape(-1).to(dest)
                                        for b in blocks]), species)
        for blocks in groups for t in range(blocks[0].shape[0])])


def density_counts_sharded_trials(groups: Sequence[Sequence[torch.Tensor]],
                                  species: int) -> torch.Tensor:
    """Counts per label 0..S of each trial of a trial batch decomposed over
    a ('pod', 'rows', 'cols') mesh: ``groups[g]`` is pod group g's blocks
    (each (n, bh, bw), contiguous on its own device, n trials in every
    group), and the result is (G * n, S+1) int32 on the first block's
    device, group after group. Each device counts the blocks of every
    group there in one launch (a slot per group, up to ``MAX_GROUP``
    blocks a launch); a trial whose blocks lie on several devices sums its
    partials in int32, which does not depend on their order."""
    if not groups or not all(groups):
        raise ValueError("density_counts_sharded_trials takes at least one "
                         "block per group")
    first = groups[0][0]
    for blocks in groups:
        for b in blocks:
            _check_grid(b, species)
            if b.dtype != first.dtype or b.shape != first.shape:
                raise ValueError(
                    f"the blocks must be equal in shape and type, got "
                    f"{tuple(b.shape)} {b.dtype} beside {tuple(first.shape)} "
                    f"{first.dtype}")
    n = first.shape[0] if first.dim() == 3 else 0
    if not 1 <= n <= MAX_TRIALS:
        raise ValueError(f"a block of a trial batch is (n, bh, bw) with 1 <= "
                         f"n <= {MAX_TRIALS}, got {tuple(first.shape)}")
    if first.device.type == "cpu":
        return density_counts_sharded_trials_plain(groups, species)
    # device -> its (group, block) pairs, in mesh order
    by_device: Dict[torch.device, List[Tuple[int, torch.Tensor]]] = {}
    for g, blocks in enumerate(groups):
        for b in blocks:
            by_device.setdefault(b.device, []).append((g, b))
    dest = first.device
    total = None
    for dev, pairs in by_device.items():
        for c in range(0, len(pairs), MAX_GROUP):
            chunk = pairs[c:c + MAX_GROUP]
            present = sorted({g for g, _ in chunk})
            slot = {g: i for i, g in enumerate(present)}
            out = torch.empty((len(present) * n, species + 1),
                              dtype=torch.int32, device=dev)
            _launch([b for _, b in chunk], n, species, out,
                    [slot[g] for g, _ in chunk],
                    "density_counts_sharded_trials")
            LAUNCHES["density_counts_sharded_trials"] += 1
            if len(present) == len(groups) and dev == dest and total is None:
                total = out
                continue
            part = torch.zeros((len(groups), n, species + 1),
                               dtype=torch.int32, device=dev)
            part[present] = out.view(len(present), n, species + 1)
            part = part.view(len(groups) * n, species + 1).to(dest)
            total = part if total is None else total + part
    return total
