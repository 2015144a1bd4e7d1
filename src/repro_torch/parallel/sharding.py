"""Device meshes and sharding rules of the port (port of
``repro.parallel.sharding``, DESIGN.md §5–§6).

The lattice half: a :class:`LatticeMesh` is an (R, C) array of
``torch.device``s: block (ri, ci) of a lattice split into R x C
contiguous blocks lives on ``devices[ri][ci]``. A :class:`PodMesh` is a
(P, R, C) array, the composed ('pod', 'rows', 'cols') mesh of the
``sharded_pod`` engine: pod group g runs its slice of the trials on the
('rows', 'cols') mesh ``group(g)``. Entries may repeat: four ``cpu``
entries stand in for the reference's fake host devices in the tests, four
``cuda:0`` entries run the whole decomposition on one card. One process
drives every block, as ``shard_map`` does for the reference.

The LM half: logical axis -> mesh axis rules. One rules table drives
params, optimizer state, caches and activations:
  * TP: q_heads / kv_heads / ffn / vocab / experts / mamba-inner -> 'model'
  * FSDP (ZeRO-3): the 'embed' axis of weights -> 'data'
  * DP: 'batch' -> ('pod', 'data') on the multi-pod mesh
  * SP: 'kv_seq' -> 'data' for single-sequence long-context decode
A layout is a spec, one entry per tensor dim (``None``, a mesh-axis name,
or a tuple of them), as the reference's ``PartitionSpec``; the port
places a leaf as a ``DTensor`` on a ``DeviceMesh`` with the placements
of that spec (``placements``). The rules are pure functions of the
mesh's axis names and sizes (``axis_sizes``): a ``DeviceMesh`` or a
``{name: size}`` dict, so the production layouts are computed without a
process group.

A dim sharded over several mesh axes: the reference's ``embed`` on the
multi-pod mesh is ``("data", "pod")``, data the major axis; a DTensor
splits one dim over several mesh dims in mesh order, 'pod' first. Both
hold the same global values on the same number of shards; which device
holds which shard differs. The spec keeps the reference's tuple.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from ..core.device import Devices, resolve_devices

__all__ = ["LatticeMesh", "PodMesh", "auto_shard_grid", "lattice_mesh",
           "pod_lattice_mesh", "DEFAULT_RULES", "Layout", "axis_sizes",
           "make_rules", "fit_spec", "placements", "placements_tree",
           "distribute_tree", "batch_sharding", "distribute_batch",
           "scalar_sharding"]


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


# ----------------------- LM logical-axis rules ---------------------------- #

# Default logical-axis rules (mesh axes: pod?, data, model).
DEFAULT_RULES: Dict[str, Optional[Any]] = {
    # weights
    "embed": "data",            # FSDP shard of the model dim
    "vocab": "model",
    "q_heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "ffn": "model",
    "experts": "model",         # EP
    "experts_r": None,          # router output dim (small)
    "expert_ffn": None,
    "layers": None,             # the layer loop; never sharded
    # mamba
    "inner": "model",
    "inner2": "model",
    "inner_zxbcdt": "model",
    "dbc": None,
    "dt_rank": None,
    "state": None,
    "conv": None,
    "heads": "model",
    # activations / caches
    "batch": ("pod", "data"),
    "seq": None,
    "kv_seq": None,
    "act_batch": ("pod", "data"),   # activation constraints (ctx.constrain)
    "act_seq": "model",             # Megatron-style sequence parallelism
}

Spec = Tuple[Any, ...]


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size}, in mesh order, of a ``DeviceMesh`` or of such a
    dict itself."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def make_rules(mesh, overrides: Optional[Dict[str, Any]] = None,
               shape_kind: str = "train",
               global_batch: Optional[int] = None) -> Dict[str, Any]:
    """The rules of one cell: ``DEFAULT_RULES`` adjusted to the mesh's
    axes, the shape's kind and its global batch, then ``overrides``."""
    rules = dict(DEFAULT_RULES)
    sizes = axis_sizes(mesh)
    if "pod" not in sizes:
        rules["batch"] = ("data",)
        rules["act_batch"] = ("data",)
    else:
        # multi-pod: ZeRO-3 over pod x data (the 1T MoE needs 512-way
        # weight sharding)
        rules["embed"] = ("data", "pod")
    if shape_kind == "decode":
        # KV caches: kv-head counts (4-8) rarely divide the 16-way model
        # axis, so shard the cache SEQUENCE over 'model' instead
        rules["kv_seq"] = "model"
    if global_batch is not None:
        # single-sequence long-context decode: batch unshardable ->
        # sequence parallelism over BOTH axes
        dp = sizes.get("data", 1) * sizes.get("pod", 1)
        if global_batch < dp:
            rules["batch"] = None
            rules["kv_seq"] = ("data", "model")
    if overrides:
        rules.update(overrides)
    return rules


def _axis_size(mesh, axis) -> int:
    sizes = axis_sizes(mesh)
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        n = 1
        for a in axis:
            n *= sizes[a]
        return n
    return sizes[axis]


def _names(axis) -> Tuple[str, ...]:
    if axis is None:
        return ()
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def _canonical(axis):
    """A one-name tuple as the name, as ``PartitionSpec`` stores it."""
    if isinstance(axis, (tuple, list)):
        return axis[0] if len(axis) == 1 else tuple(axis)
    return axis


def fit_spec(shape, spec: Spec, mesh) -> Spec:
    """Drop shardings whose axis size does not divide the dimension (24
    q-heads or a 51865 vocab on a 16-way model axis) and a mesh axis a
    dim before already used: the reference's fallback."""
    out = []
    used = set()
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    for dim, axis in zip(shape, spec):
        if axis is not None and dim % _axis_size(mesh, axis) != 0:
            axis = None
        names = _names(axis)
        if any(n in used for n in names):      # each mesh axis used once
            axis = None
        else:
            used.update(names)
        out.append(_canonical(axis))
    return tuple(out)


def placements(spec: Spec, mesh) -> tuple:
    """The DTensor placements, one per mesh dim, of a fitted spec: Shard(d)
    on each mesh dim that tensor dim d names, Replicate elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    where = {n: d for d, axis in enumerate(spec) for n in _names(axis)}
    return tuple(Shard(where[n]) if n in where else Replicate()
                 for n in axis_sizes(mesh))


class Layout(NamedTuple):
    """One leaf's layout: its fitted spec and its DTensor placements."""
    spec: Spec
    placements: tuple


def placements_tree(spec_tree, mesh, rules: Dict[str, Any]):
    """ParamSpec tree -> ``Layout`` tree (the reference's
    ``named_sharding_tree``), validated against the mesh's sizes."""
    from ..models import spec as spec_mod

    def leaf(path, s):
        fitted = fit_spec(s.shape, spec_mod.partition_spec(s, rules), mesh)
        return Layout(fitted, placements(fitted, mesh))
    return spec_mod.map_specs(leaf, spec_tree)


def distribute_tree(tree, spec_tree, mesh, rules: Dict[str, Any]):
    """A tree of tensors (params, a train state, a cache) as DTensors on
    ``mesh`` by the rules. Every rank holds the same whole leaves and
    keeps its own shard (no collective)."""
    from torch.distributed.tensor import distribute_tensor

    from ..models import spec as spec_mod
    layouts = placements_tree(spec_tree, mesh, rules)
    return spec_mod.tree_map(
        lambda t, lay: distribute_tensor(t, mesh, lay.placements,
                                         src_data_rank=None),
        tree, layouts)


def batch_sharding(mesh, rules: Dict[str, Any]) -> Callable[[int], tuple]:
    """Placements of an input batch of ``ndim`` dims: its leading dim over
    the rule's 'batch' axes, the rest replicated."""
    b = rules.get("batch")

    def shard_for(ndim: int) -> tuple:
        spec = (_canonical(b),) + (None,) * (ndim - 1)
        return placements(spec, mesh)
    return shard_for


def distribute_batch(batch: Dict[str, torch.Tensor], mesh,
                     rules: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Every input of a batch as a DTensor placed by ``batch_sharding``
    (a batch that the axes do not divide stays replicated)."""
    from torch.distributed.tensor import distribute_tensor
    out = {}
    for k, v in batch.items():
        spec = fit_spec(v.shape, (rules.get("batch"),), mesh)
        out[k] = distribute_tensor(v, mesh, placements(spec, mesh),
                                   src_data_rank=None)
    return out


def scalar_sharding(mesh) -> tuple:
    """Placements of a replicated leaf (a step count, a loss)."""
    return placements((), mesh)
