"""The lattice's device mesh (port of the ESCG part of
``repro.parallel.sharding``, DESIGN.md §5–§6).

A :class:`LatticeMesh` is an (R, C) array of ``torch.device``s: block
(ri, ci) of a lattice split into R x C contiguous blocks lives on
``devices[ri][ci]``. A :class:`PodMesh` is a (P, R, C) array, the
composed ('pod', 'rows', 'cols') mesh of the ``sharded_pod`` engine: pod
group g runs its slice of the trials on the ('rows', 'cols') mesh
``group(g)``. Entries may repeat: four ``cpu`` entries stand in for the
reference's fake host devices in the tests, four ``cuda:0`` entries run
the whole decomposition on one card. One process drives every block, as
``shard_map`` does for the reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ..core.device import Devices, resolve_devices

__all__ = ["LatticeMesh", "PodMesh", "auto_shard_grid", "lattice_mesh",
           "pod_lattice_mesh"]


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


@dataclass(frozen=True)
class PodMesh:
    """Devices of a ('pod', 'rows', 'cols') mesh, ``devices[g][ri][ci]``."""
    devices: Tuple[Tuple[Tuple[torch.device, ...], ...], ...]
    axis_names: Tuple[str, str, str] = ("pod", "rows", "cols")

    @property
    def shape(self) -> Tuple[int, int, int]:
        return (len(self.devices), len(self.devices[0]),
                len(self.devices[0][0]))

    @property
    def first(self) -> torch.device:
        """The mesh's first device: where the trials' statistics land."""
        return self.devices[0][0][0]

    @property
    def flat(self) -> Tuple[torch.device, ...]:
        """Every entry in raster order."""
        return tuple(d for grp in self.devices for row in grp for d in row)

    def group(self, g: int) -> LatticeMesh:
        """Pod group g's ('rows', 'cols') mesh."""
        return LatticeMesh(self.devices[g])


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


def pod_lattice_mesh(mesh_shape, height: int, width: int, tile_h: int,
                     tile_w: int, devices: Optional[Devices] = None
                     ) -> PodMesh:
    """Composed ('pod', 'rows', 'cols') mesh of the ``sharded_pod`` engine
    over the first P·R·C of ``devices`` in raster order (``None``: every
    visible card): the trials shard over 'pod' while each trial's lattice
    is decomposed over ('rows', 'cols'). ``mesh_shape=None`` puts every
    device on the pod axis. The ('rows', 'cols') factors obey the
    ``sharded`` engine's rule: every block is a union of (tile_h, tile_w)
    tiles. Checks and messages are the reference's."""
    devs = resolve_devices(devices)
    if mesh_shape is None:
        mesh_shape = (len(devs), 1, 1)
    pp, dr, dc = mesh_shape
    if pp < 1 or dr < 1 or dc < 1:
        raise ValueError(f"mesh_shape dims must be >= 1, got {mesh_shape}")
    if pp * dr * dc > len(devs):
        raise ValueError(f"mesh_shape {tuple(mesh_shape)} needs "
                         f"{pp * dr * dc} devices; only {len(devs)} "
                         "available")
    if height % dr or (height // dr) % tile_h:
        raise ValueError(f"rows={dr} must split height={height} into "
                         f"multiples of tile_h={tile_h}")
    if width % dc or (width // dc) % tile_w:
        raise ValueError(f"cols={dc} must split width={width} into "
                         f"multiples of tile_w={tile_w}")
    return PodMesh(tuple(
        tuple(tuple(devs[(g * dr + r) * dc:(g * dr + r + 1) * dc])
              for r in range(dr))
        for g in range(pp)))
