"""Species histogram kernel (port of ``repro.kernels.density``).

K4, ``density_counts``: the counts of labels 0..S over an (H, W) lattice,
(S+1,) int32; labels outside 0..S are not counted. The CUDA kernel is
``density_kernel`` in ``csrc/density.cu``: one launch of 16-byte loads,
counts in registers (shared-memory bins above 16 labels), each block's
sums added into a scratch buffer that the last block moves into the
output; integer sums, so exact. Its plain version is the reference's
one-hot sum.

``density_counts_sharded`` is the count of a lattice split into blocks
over a device mesh (the reference lifts K4 into a ``shard_map`` and
``psum``s the partials): K4 on every block, on the block's device, and
the (S+1,) int32 partials summed on the mesh's first device. It adds no
kernel of its own. Its plain twin is ``density_counts_plain`` of the
gathered lattice.

The wrapper launches the kernel for a CUDA grid and takes the plain
version only for a CPU grid. ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import torch

from . import build

LAUNCHES = {"density_counts": 0}

_LIB = "density"
MAX_LABELS = 4096      # the bins live in a block's shared memory

# (device, stream) -> that stream's scratch: the ticket and the
# MAX_LABELS accumulators, zero between launches (each launch's last block
# zeroes them again). Launches on one stream run in order, so they share it.
_SCRATCH: Dict[Tuple[int, int], torch.Tensor] = {}


def _lib() -> ctypes.CDLL:
    lib = build.load(_LIB)
    fn = lib.density_counts
    if fn.argtypes is None:
        i32, ptr = ctypes.c_int, ctypes.c_void_p
        fn.argtypes = [i32, ptr, ctypes.c_int64, i32, ptr, ptr, i32, ptr]
        fn.restype = i32
    return lib


def _scratch(grid: torch.Tensor, device: int,
             stream: ctypes.c_void_p) -> torch.Tensor:
    """The scratch of the launch's stream, made zero at its first use."""
    key = (device, stream.value or 0)
    buf = _SCRATCH.get(key)
    if buf is None:
        buf = _SCRATCH[key] = torch.zeros(1 + MAX_LABELS, dtype=torch.int32,
                                          device=grid.device)
    return buf


def density_counts_plain(grid: torch.Tensor, species: int) -> torch.Tensor:
    """Plain version of K4 (any device): the one-hot of every cell over
    labels 0..S, summed."""
    labels = torch.arange(species + 1, device=grid.device)
    return (grid.reshape(-1, 1) == labels).sum(dim=0, dtype=torch.int32)


def density_counts(grid: torch.Tensor, species: int) -> torch.Tensor:
    """Counts per label 0..S of a contiguous int8/int16/int32 lattice
    (any shape; a view that starts inside its storage is fine), (S+1,)
    int32 on the grid's device."""
    if grid.dtype not in build.CELL_DTYPES:
        raise ValueError(f"grid dtype must be int8/int16/int32, got "
                         f"{grid.dtype}")
    if not grid.is_contiguous():
        raise ValueError("density_counts takes a contiguous grid")
    if not 0 <= species < MAX_LABELS:
        raise ValueError(f"species must be in [0, {MAX_LABELS}), got "
                         f"{species}")
    if grid.device.type == "cpu":
        return density_counts_plain(grid, species)
    device, stream = build.launch_args(grid)
    scratch = _scratch(grid, device, stream)
    out = torch.empty(species + 1, dtype=torch.int32, device=grid.device)
    lib = _lib()
    err = lib.density_counts(grid.element_size(), build.ptr(grid),
                             grid.numel(), species + 1, build.ptr(out),
                             build.ptr(scratch), device, stream)
    build.check(lib, err, "density_counts launch")
    LAUNCHES["density_counts"] += 1
    return out


def density_counts_sharded(blocks: Sequence[torch.Tensor],
                           species: int) -> torch.Tensor:
    """Counts per label 0..S of a lattice decomposed into ``blocks`` (the
    mesh's blocks in raster order, each contiguous on its own device):
    K4 on every block, then the partials copied to the first block's
    device and summed there in int32, (S+1,) int32. Integer sums do not
    depend on their order, so this equals K4 of the gathered lattice.

    Blocks on one card run in order on its current stream, so they share
    that stream's scratch. A copy between two cards waits for the
    partial on its card's stream (PyTorch orders a copy between devices
    on both devices' current streams)."""
    if not blocks:
        raise ValueError("density_counts_sharded takes at least one block")
    dest = blocks[0].device
    parts = [density_counts(b, species).to(dest) for b in blocks]
    return torch.stack(parts).sum(dim=0, dtype=torch.int32)
