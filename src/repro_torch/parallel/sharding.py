"""The lattice's device mesh (port of the ESCG part of
``repro.parallel.sharding``, DESIGN.md §5).

A :class:`LatticeMesh` is an (R, C) array of ``torch.device``s: block
(ri, ci) of a lattice split into R x C contiguous blocks lives on
``devices[ri][ci]``. Entries may repeat: four ``cpu`` entries stand in
for the reference's fake host devices in the tests, four ``cuda:0``
entries run the whole decomposition on one card. One process drives every
block, as ``shard_map`` does for the reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ..core.device import Devices, resolve_devices

__all__ = ["LatticeMesh", "auto_shard_grid", "lattice_mesh"]


@dataclass(frozen=True)
class LatticeMesh:
    """Devices of a ('rows', 'cols') mesh, ``devices[ri][ci]``."""
    devices: Tuple[Tuple[torch.device, ...], ...]
    axis_names: Tuple[str, str] = ("rows", "cols")

    @property
    def shape(self) -> Tuple[int, int]:
        return len(self.devices), len(self.devices[0])

    @property
    def first(self) -> torch.device:
        """The mesh's first device: where sums and gathers land."""
        return self.devices[0][0]

    @property
    def flat(self) -> Tuple[torch.device, ...]:
        """Every entry in raster order."""
        return tuple(d for row in self.devices for d in row)


def auto_shard_grid(n_devices: int, height: int, width: int,
                    tile_h: int, tile_w: int) -> tuple:
    """Pick a (rows, cols) device grid for the sharded ESCG engine.

    Every device block must be a union of (tile_h, tile_w) tiles: rows |
    height, cols | width, and the block a tile multiple. Among the
    factorizations of d = n_devices, n_devices - 1, ... the first feasible
    d wins (as many devices as the lattice admits), and within it the most
    square split (the least perimeter, so the least halo traffic)."""
    def feasible(dr, dc):
        return (height % dr == 0 and (height // dr) % tile_h == 0
                and width % dc == 0 and (width // dc) % tile_w == 0)

    for d in range(n_devices, 0, -1):
        pairs = [(dr, d // dr) for dr in range(1, d + 1) if d % dr == 0]
        pairs = [pq for pq in pairs if feasible(*pq)]
        if pairs:
            return min(pairs, key=lambda pq: abs(pq[0] - pq[1]))
    return (1, 1)


def lattice_mesh(shard_grid, height: int, width: int, tile_h: int,
                 tile_w: int, devices: Optional[Devices] = None
                 ) -> LatticeMesh:
    """Mesh over the 2-D lattice decomposition, on the first R·C of
    ``devices`` in raster order (``None``: every visible card).
    ``shard_grid=None`` picks the largest feasible grid (possibly leaving
    devices idle when the lattice does not factor). A grid that needs
    more devices than were given raises; the mesh is never shrunk."""
    devs = resolve_devices(devices)
    if shard_grid is None:
        shard_grid = auto_shard_grid(len(devs), height, width, tile_h,
                                     tile_w)
    dr, dc = shard_grid
    if dr < 1 or dc < 1:
        raise ValueError("shard_grid dims must be >= 1")
    if dr * dc > len(devs):
        raise ValueError(f"shard_grid {tuple(shard_grid)} needs {dr * dc} "
                         f"devices; only {len(devs)} available")
    return LatticeMesh(tuple(tuple(devs[r * dc:(r + 1) * dc])
                             for r in range(dr)))
