"""Lightweight parameter-spec module system (port of ``repro.models.spec``).

Models declare parameters as trees (nested dicts) of ``ParamSpec`` (shape
+ dtype + logical axes + initializer). From one spec tree the port
derives:
  * abstract params, tensors on the ``meta`` device: a 1T-parameter model
    never allocates;
  * concrete params, each leaf drawn from a key folded in from its path
    (``_leaf_key``), bit for bit the reference's bits;
  * the helpers over trees of tensors the optimizers, checkpoints and
    train step share (``tree_map``, ``tree_leaves``), leaves in sorted key
    order as ``jax.tree`` orders a dict.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import threefry
from ..core.device import DeviceLike, resolve_device

Tree = Any

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16, "int32": torch.int32,
          "int8": torch.int8}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a spec's dtype name."""
    if name not in DTYPES:
        raise ValueError(f"unknown dtype {name!r}; have {sorted(DTYPES)}")
    return DTYPES[name]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]          # logical axis names, len == ndim
    init: str = "normal"                     # normal | zeros | ones | scaled
    scale: float = 1.0                       # stddev multiplier / fan-in mode
    dtype: str = "float32"

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"axes {self.axes} do not match shape "
                             f"{self.shape}")


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_paths(tree: Tree, prefix: str = "") -> Dict[str, ParamSpec]:
    out = {}
    if is_spec(tree):
        out[prefix] = tree
        return out
    for k in sorted(tree.keys()):
        out.update(tree_paths(tree[k], f"{prefix}/{k}" if prefix else k))
    return out


def map_specs(fn: Callable[[str, ParamSpec], Any], tree: Tree,
              prefix: str = "") -> Tree:
    if is_spec(tree):
        return fn(prefix, tree)
    return {k: map_specs(fn, v, f"{prefix}/{k}" if prefix else k)
            for k, v in tree.items()}


def tree_leaves(tree: Tree) -> List[Any]:
    """The leaves of a tree of dicts, keys in sorted order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` of the leaves of ``tree`` and of the trees of the same
    structure in ``rest``, called in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def abstract(tree: Tree) -> Tree:
    """Shape and dtype of every leaf as a tensor on the ``meta`` device."""
    return map_specs(
        lambda p, s: torch.empty(s.shape, dtype=torch_dtype(s.dtype),
                                 device="meta"), tree)


def _leaf_key(key: torch.Tensor, path: str) -> torch.Tensor:
    h = np.uint32(np.frombuffer(
        path.encode(), dtype=np.uint8).astype(np.uint64).sum() * 2654435761
        % (2 ** 31))
    return threefry.fold_in(key, int(h))


def _fan_in(shape: Tuple[int, ...]) -> int:
    # convention: last axis is the output axis for >=2D weights
    if len(shape) <= 1:
        return 1
    return int(np.prod(shape[:-1]))


def initialize(tree: Tree, key: torch.Tensor,
               device: Optional[DeviceLike] = None) -> Tree:
    """Concrete leaves on ``device`` (default: the card): zeros, ones, or
    ``normal(leaf key) * scale / sqrt(fan_in)`` drawn in float32 and cast
    to the leaf's dtype, as the reference draws them under the
    non-partitionable threefry scheme (``threefry.normal``: the bits
    exact, a value within a few float32 ulps)."""
    dev = resolve_device(device)

    def init_leaf(path: str, s: ParamSpec):
        dt = torch_dtype(s.dtype)
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=dt, device=dev)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=dt, device=dev)
        std = float(np.float32(s.scale / np.sqrt(_fan_in(s.shape))))
        return threefry.normal(_leaf_key(key, path), s.shape, device=dev,
                               std=std, dtype=dt)
    return map_specs(init_leaf, tree)


def partition_spec(s: ParamSpec, rules: Dict[str, Optional[Any]]
                   ) -> Tuple[Any, ...]:
    """One leaf's logical axes through a rules dict: a mesh-axis name, a
    tuple of them or ``None`` per dim (the reference's ``PartitionSpec``
    entries)."""
    return tuple(rules.get(a) if a is not None else None for a in s.axes)


def partition_tree(tree: Tree, rules: Dict[str, Optional[Any]],
                   mesh=None) -> Tree:
    """logical axes -> a spec tuple per leaf via a rules dict; with a
    ``mesh`` (a ``DeviceMesh`` or ``{axis: size}``), the spec fitted to it
    (``parallel.sharding.fit_spec``: an axis that does not divide its dim,
    or is used twice, dropped)."""
    if mesh is None:
        return map_specs(lambda p, s: partition_spec(s, rules), tree)
    from ..parallel.sharding import fit_spec
    return map_specs(
        lambda p, s: fit_spec(s.shape, partition_spec(s, rules), mesh), tree)


def count_params(tree: Tree) -> int:
    return sum(int(np.prod(s.shape)) for s in tree_paths(tree).values())


def param_bytes(tree: Tree) -> int:
    return sum(int(np.prod(s.shape)) * torch_dtype(s.dtype).itemsize
               for s in tree_paths(tree).values())


def stack_layers(tree: Tree, n_layers: int) -> Tree:
    """Prepend a 'layers' axis to every leaf (the stacked layer loop)."""
    return map_specs(
        lambda p, s: dataclasses.replace(
            s, shape=(n_layers,) + s.shape, axes=("layers",) + s.axes), tree)
