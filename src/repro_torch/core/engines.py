"""Engine registry (port of ``repro.core.engines``, DESIGN.md §2).

The port registers the fused-Philox sublattice engine ``pallas_fused``;
every other engine of the reference is named here with the ``ROADMAP.md``
item that ports it, and asking for one raises ``NotImplementedError``.

Engine contract in the port: ``build(params, dom, device) -> BuiltEngine``.
The per-MCS key chain does not depend on the lattice, so it runs on the
host, once per chunk (``schedule``), and the launches then take its seed
words and shifts:

* ``schedule(key, n) -> (key', seeds (n, 2), shifts (n, 2))`` on the host:
  the MCS loop's ``key, k1 = split(key)`` chain with ``fused_round_inputs``
  of every ``k1``, exactly as ``multi_round_inputs`` replays it;
* ``one_mcs(grid, seed, shift) -> grid``: one MCS, one K1 launch;
* ``multi_mcs(grid, seeds, shifts) -> (grid, counts)``: K MCS in one K2
  launch, ``seeds``/``shifts`` (K, 2) on the grid's device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import (Callable, Dict, NamedTuple, Optional, Tuple,
                    TYPE_CHECKING)

import torch

from . import threefry
from .device import DeviceLike, resolve_device
from .lattice import DIRS
from .results import STREAM_NAMES
from .rng import round_shift

if TYPE_CHECKING:  # params validates through this module
    from .params import EscgParams


class BuiltEngine(NamedTuple):
    """A ready-to-run engine for one (params, dominance, device)."""
    schedule: Callable[[torch.Tensor, int],
                       Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]
    one_mcs: Callable[[torch.Tensor, Tuple[int, int], Tuple[int, int]],
                      torch.Tensor]
    multi_mcs: Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                        Tuple[torch.Tensor, torch.Tensor]]
    attempts_per_mcs: int
    device: torch.device


@dataclass(frozen=True)
class EngineCaps:
    """Static capability metadata consumed by params validation."""
    flux_only: bool = False    # requires periodic (torus) boundaries
    tiled: bool = False        # consumes params.tile; tile must divide grid
    multi_mcs: bool = False    # supports params.k_mcs > 1 (the megakernel)


@dataclass(frozen=True)
class EngineSpec:
    name: str
    caps: EngineCaps
    build: Callable = field(repr=False, default=None)


_REGISTRY: Dict[str, EngineSpec] = {}

# engines of the reference that this port does not run yet, with the
# ROADMAP.md item that ports each
NOT_PORTED = {
    "reference": "Queue 1, 'reference and batched engines'",
    "batched": "Queue 1, 'reference and batched engines'",
    "sublattice": "Queue 1, 'stream-fed sublattice engine'",
    "pallas": "Queue 1, 'stream-fed sublattice engine' (with Queue 2, K3)",
    "sharded": "Queue 1, 'multi-GPU engines'",
    "sharded_pod": "Queue 1, 'multi-GPU engines'",
}


def register(name: str, caps: EngineCaps):
    """Decorator: register ``build(params, dom, device) -> BuiltEngine``."""
    def deco(build_fn):
        _REGISTRY[name] = EngineSpec(name=name, caps=caps, build=build_fn)
        return build_fn
    return deco


def engine_names() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


def get_engine(name: str) -> EngineSpec:
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"engine {name!r} is not ported to repro_torch yet; it is "
            f"ROADMAP.md {NOT_PORTED[name]}. Ported: {engine_names()}")
    raise ValueError(f"unknown engine {name!r}; registered: "
                     f"{engine_names()}")


def validate_params(p: "EscgParams") -> None:
    """Capability-driven validation (called from EscgParams.validate)."""
    spec = get_engine(p.engine)
    if spec.caps.flux_only and not p.flux:
        raise ValueError(
            f"engine {p.engine!r} requires flux (periodic) boundaries")
    if spec.caps.tiled:
        th, tw = p.tile
        if th < 3 or tw < 3:
            raise ValueError("tile dims must be >= 3 (need interior)")
        if p.height % th or p.length % tw:
            raise ValueError(f"tile {p.tile} must divide lattice "
                             f"{p.height}x{p.length}")
    if p.local_kernel not in ("jnp", "pallas", "fused"):
        raise ValueError("local_kernel must be 'jnp', 'pallas' or 'fused'")
    if p.k_mcs < 1:
        raise ValueError(f"k_mcs must be >= 1, got {p.k_mcs}")
    if p.k_mcs > 1 and not spec.caps.multi_mcs:
        raise ValueError(f"engine {p.engine!r} does not support k_mcs > 1")
    if p.obs_capacity < 0:
        raise ValueError(f"obs_capacity must be >= 0, got {p.obs_capacity}")
    for name in p.observables:
        if name not in STREAM_NAMES:
            raise ValueError(f"unknown observable {name!r}; known: "
                             f"{STREAM_NAMES}")
    if p.mesh_shape is not None:
        raise ValueError(f"engine {p.engine!r} does not lay devices on a "
                         "('pod','rows','cols') mesh; mesh_shape does not "
                         "apply")


def build(params, dom=None, device: Optional[DeviceLike] = None
          ) -> BuiltEngine:
    """Resolve ``params.engine`` (an ``EscgParams`` or a ``Scenario``) and
    build it on ``device`` (default: the card). ``dom=None`` takes the
    scenario's dominance network, or the circulant C(S, {1})."""
    from .scenarios import resolve_config  # scenarios imports this module
    params, dom = resolve_config(params, dom)
    params = params.validate()
    dev = resolve_device(device)
    if dom is None:
        from . import dominance as dom_mod
        dom = dom_mod.circulant(params.species)
    dom = torch.as_tensor(dom, dtype=torch.float32).to(dev).contiguous()
    return get_engine(params.engine).build(params, dom, dev)


# --------------------------- registered engines --------------------------- #

def _tiled_setup(p: "EscgParams"):
    """Tile bookkeeping of the sublattice-family engines."""
    th, tw = p.tile
    n_tiles = (p.height // th) * (p.length // tw)
    k_per_tile = max(1, math.ceil(p.n_cells / n_tiles))
    interior = (th - 2) * (tw - 2)
    return th, tw, n_tiles, k_per_tile, interior


def fused_round_inputs(key: torch.Tensor, th: int, tw: int):
    """Per-MCS (Philox seed words, window shift) of the fused-PRNG family:
    seed = the raw key words, shift keyed by ``fold_in(key, 1)``."""
    seed = threefry.key_data(key)[-2:]
    shift = round_shift(threefry.fold_in(key, 1), th, tw)
    return seed, shift


def multi_round_inputs(key: torch.Tensor, th: int, tw: int, k_steps: int):
    """The K-step fused schedule ``(key', seeds (K, 2), shifts (K, 2))``,
    int64 on the host. Replays the MCS loop's per-MCS key chain — ``key, k1
    = split(key); fused_round_inputs(k1)`` K times — so K steps from it
    equal K single-MCS calls, and ``key'`` is the loop's key after K
    MCS."""
    seeds = torch.zeros((k_steps, 2), dtype=torch.int64)
    shifts = torch.zeros((k_steps, 2), dtype=torch.int64)
    for t in range(k_steps):
        key, k1 = threefry.split(key)
        seeds[t], shifts[t] = fused_round_inputs(k1, th, tw)
    return key, seeds, shifts


@register("pallas_fused", EngineCaps(flux_only=True, tiled=True,
                                     multi_mcs=True))
def _build_pallas_fused(p: "EscgParams", dom: torch.Tensor,
                        device: torch.device) -> BuiltEngine:
    """Sublattice sweep with in-kernel Philox proposals (the paper's
    numRandoms buffer of §3.2.1 eliminated): CUDA kernel K1 for one MCS,
    K2 for k_mcs MCS per launch."""
    from ..kernels import ops as kernel_ops  # kernels import core modules
    t_eps, t_eps_mu = p.action_thresholds()
    th, tw, n_tiles, k_per_tile, _ = _tiled_setup(p)
    dirs = torch.as_tensor(DIRS, dtype=torch.int32).to(device)

    def schedule(key, n_mcs):
        return multi_round_inputs(key, th, tw, n_mcs)

    def one_mcs(grid, seed, shift):
        return kernel_ops.escg_round_fused(
            grid, seed, 0, shift, dom, dirs, p.tile, k_per_tile, t_eps,
            t_eps_mu, p.neighbourhood, roll_back=False)

    def multi_mcs(grid, seeds, shifts):
        return kernel_ops.escg_rounds_fused(
            grid, seeds, shifts, dom, dirs, p.tile, k_per_tile, t_eps,
            t_eps_mu, p.species, p.neighbourhood)

    return BuiltEngine(schedule, one_mcs, multi_mcs,
                       attempts_per_mcs=n_tiles * k_per_tile, device=device)
