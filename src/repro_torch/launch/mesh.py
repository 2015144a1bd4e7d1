"""Production mesh construction (port of ``repro.launch.mesh``).

Functions, not module-level constants: importing this module touches no
device and no process group.

The LM meshes are ``torch.distributed`` ``DeviceMesh``es, one rank per
GPU: (16, 16) ``data x model`` (256 H100s) or (2, 16, 16) ``pod x data x
model`` (512), the reference's shapes; every axis spans more than one
8-GPU node. They need an initialized process group of the mesh's size
(``torch.distributed.init_process_group``, or a fake group for the
dry-run). The ESCG composed mesh (``make_composed_mesh``) is the port's
``PodMesh``, a device list one process drives.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: Optional[str] = None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over every rank of the
    initialized process group, on the card (``"cuda"``) unless
    ``device_type="cpu"`` is given. The group's size must be the mesh's."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    dev = device_type or "cuda"
    if dev not in ("cuda", "cpu"):
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got {dev}")
    if dev == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a mesh is on the card by default and CUDA is not available "
            "here; pass device_type='cpu' for a CPU (gloo) mesh")
    n = int(np.prod(shape))
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {shape} mesh needs an initialized process group of {n} "
            "ranks (torch.distributed.init_process_group)")
    if dist.get_world_size() != n:
        raise ValueError(f"a {shape} mesh needs {n} ranks; the process "
                         f"group has {dist.get_world_size()}")
    return init_device_mesh(dev, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    """(16, 16) ``data x model`` or, ``multi_pod``, (2, 16, 16) ``pod x
    data x model``: 256 or 512 ranks."""
    shape, axes = PRODUCTION_SHAPES[bool(multi_pod)]
    return make_mesh(shape, axes, device_type)


def make_composed_mesh(mesh_shape: Optional[Tuple[int, int, int]] = None,
                       *, height: int = 0, width: int = 0,
                       tile=(8, 32), devices=None):
    """The ESCG composed trial x grid mesh, ('pod', 'rows', 'cols'), as
    the ``sharded_pod`` engine builds it
    (``parallel.sharding.pod_lattice_mesh``): pass height, width and tile
    for its tile-divisibility checks, or leave them 0 for the layout
    alone. ``devices``: a device list (``None``: every visible card)."""
    from ..core.device import resolve_devices
    from ..parallel.sharding import PodMesh, pod_lattice_mesh

    if height and width:
        return pod_lattice_mesh(mesh_shape, height, width, tile[0], tile[1],
                                devices)
    devs = resolve_devices(devices)
    pp, dr, dc = (tuple(mesh_shape) if mesh_shape is not None
                  else (len(devs), 1, 1))
    if pp < 1 or dr < 1 or dc < 1:
        raise ValueError(f"mesh_shape dims must be >= 1, got {mesh_shape}")
    if pp * dr * dc > len(devs):
        raise ValueError(f"mesh_shape {(pp, dr, dc)} needs {pp * dr * dc} "
                         f"devices; only {len(devs)} available")
    return PodMesh(tuple(
        tuple(tuple(devs[(g * dr + r) * dc:(g * dr + r + 1) * dc])
              for r in range(dr))
        for g in range(pp)))


def n_chips(mesh) -> int:
    """Devices in a mesh: a ``DeviceMesh``'s ranks, or a lattice mesh's
    entries."""
    if hasattr(mesh, "flat"):
        return len(mesh.flat)
    return int(mesh.size())
