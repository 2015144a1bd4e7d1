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
order, and each device counts its blocks in one launch of
``density_grouped_kernel`` (``csrc/density.cu``: the blocks' pointers
passed by value, one slice of the grid per block, one scratch and one
ticket for all), up to ``MAX_GROUP`` blocks a launch; more blocks on a
device make more launches, whose counts are summed there. Only a mesh
over several devices copies its partials to the first device and sums
them in int32. Its plain twin is ``density_counts_plain`` of the gathered
lattice.

K4 per trial, ``density_counts_trials``: the counts of each lattice of a
batch of IID trials stacked as one (n, ...) tensor, (n, S+1) int32, in one
launch of K4's ``density_kernel``, which counts a lattice as a batch of
one: one slice of the grid per trial, each with its own accumulators and
ticket in a scratch that grows with the batch. Its plain version is K4's,
trial by trial.

The wrappers launch the kernels for CUDA tensors and take the plain
versions only for CPU tensors. ``LAUNCHES`` counts kernel launches, the
per-trial form's under its own name.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import torch

from . import build

LAUNCHES = {"density_counts": 0, "density_counts_sharded": 0,
            "density_counts_trials": 0}

_LIB = "density"
MAX_LABELS = 4096      # the bins live in a block's shared memory
MAX_GROUP = 32         # blocks in one K4s launch (kMaxGroup of the source)
MAX_TRIALS = 65535     # trials in one per-trial launch (the grid's y extent)

# (device, stream) -> that stream's scratch: the tickets and accumulators
# of K4 (a ticket and S+1 words a trial) and K4s (one ticket and S+1
# words), zero between launches (each launch's last blocks zero them
# again). Launches on one stream run in order, so they share it; a batch
# that outgrows it replaces it with a larger zero buffer (the stream's
# order keeps the old one alive until its last launch is done).
_SCRATCH: Dict[Tuple[int, int], torch.Tensor] = {}


def _lib() -> ctypes.CDLL:
    lib = build.load(_LIB)
    fn = lib.density_counts
    if fn.argtypes is None:
        i32, ptr = ctypes.c_int, ctypes.c_void_p
        fn.argtypes = [i32, ptr, i32, ctypes.c_int64, i32, ptr, ptr, i32,
                       ptr]
        fn.restype = i32
        grouped = lib.density_counts_grouped
        grouped.argtypes = [i32, ptr, i32, ctypes.c_int64, i32, ptr, ptr,
                            i32, ptr]
        grouped.restype = i32
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


def _launch(grids: torch.Tensor, n_runs: int, species: int,
            out: torch.Tensor) -> None:
    """One K4 launch counting the n_runs equal runs stacked in ``grids``
    into ``out`` ((n_runs, S+1) int32)."""
    device, stream = build.launch_args(grids)
    scratch = _scratch(grids, device, stream, n_runs * (species + 2))
    lib = _lib()
    err = lib.density_counts(grids.element_size(), build.ptr(grids), n_runs,
                             grids.numel() // n_runs, species + 1,
                             build.ptr(out), build.ptr(scratch), device,
                             stream)
    build.check(lib, err, "density_counts launch")


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
    _launch(grid, 1, species, out)
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
    device, stream = build.launch_args(first)
    scratch = _scratch(first, device, stream, 1 + species + 1)
    out = torch.empty(species + 1, dtype=torch.int32, device=first.device)
    runs = (ctypes.c_void_p * len(blocks))(
        *(build.ptr(b).value for b in blocks))
    lib = _lib()
    err = lib.density_counts_grouped(
        first.element_size(), runs, len(blocks), first.numel(), species + 1,
        build.ptr(out), build.ptr(scratch), device, stream)
    build.check(lib, err, "density_counts_sharded launch")
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
    _launch(grids, grids.shape[0], species, out)
    LAUNCHES["density_counts_trials"] += 1
    return out
