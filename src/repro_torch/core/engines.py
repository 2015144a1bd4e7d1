"""Engine registry (port of ``repro.core.engines``, DESIGN.md §2).

The port registers the exact sequential engine ``reference`` (E1, kernel
S1 on the card), the default ``batched`` engine (E2, scatter-min
arbitration in plain PyTorch), and the sublattice family: the fused-Philox
engine ``pallas_fused`` (kernels K1, K2) and the stream-fed pair
``sublattice`` (plain PyTorch) and ``pallas`` (kernel K3), and the
domain-decomposed ``sharded`` engine (``core/sharded.py``), which runs one
of those rounds on every block of a device mesh, and ``sharded_pod``
(``core/sharded_pod.py``), which composes IID trials over a 'pod' mesh
axis with that decomposition. Only ``reference`` and ``batched`` take
reflecting boundaries.

Engine contract in the port: ``build(params, dom, device) -> BuiltEngine``
(``device`` is the tuple of mesh devices for a ``multi_device`` engine).
The per-MCS key chain does not depend on the lattice, so it runs on the
host, once per chunk (``schedule``), and the launches then take the two
words and the shift it gives each MCS:

* ``schedule(key, n) -> (key', words (n, 2), shifts (n, 2))`` on the host:
  the MCS loop's ``key, k1 = split(key)`` chain with the engine's round
  inputs of every ``k1``. For ``reference`` and ``batched`` the words are
  ``key_data(k1)`` and the shift is unused (zeros); for ``pallas_fused``
  they are the Philox seed (``fused_round_inputs``); for ``sublattice``
  and ``pallas`` they are the key data of the proposal key ``kp`` of ``kp,
  ks = split(k1)``, and the shift is drawn from ``ks``
  (``tiled_round_inputs``);
* ``one_mcs(grid, words, shift) -> (grid, kept)``: one MCS, with ``kept``
  the proposals it applied as a scalar tensor on the grid's device. The
  tiled engines apply every proposal and return their attempts, as the
  reference's ``_build_tiled`` does; ``batched`` drops contested ones;
* ``multi_mcs(grid, seeds, shifts) -> (grid, counts)``: K MCS in one K2
  launch, ``seeds``/``shifts`` (K, 2) on the grid's device (``pallas_fused``
  and ``sharded`` with ``local_kernel='fused'``, which drop nothing;
  ``None`` elsewhere);
* ``place(grid) -> lattice``, ``gather(lattice) -> grid`` and
  ``counts(lattice, species) -> (S+1,) int32``: how ``simulate`` puts the
  (H, W) lattice on the engine's devices, takes it back and counts it. The
  single-device engines keep the tensor as it is and count it with K4;
  ``sharded`` splits it into blocks over its mesh and counts them with
  ``density_counts_sharded``.

The single-device engines are ``vmappable``: the trial driver
(``core/trials.py``) runs a batch of IID trials, n lattices stacked as one
(n, H, W) tensor, with one launch per kernel and MCS for all of them:

* ``schedule_batch(keys (n, 2), n) -> (keys', words (n, n, 2), shifts (n,
  n, 2))``: the engine's ``schedule`` given a batch of keys, which runs
  every trial's chain at once with the batched threefry, one set of
  tensor ops per MCS, equal to ``schedule`` stacked over the trials;
* ``one_mcs_batch(grids, words (n, 2), shifts (n, 2)) -> (grids, kept
  (n,))`` with the words and shifts on the grids' device: K1 over the
  trials (``pallas_fused``), the trials' stream draws then K3 over the
  trials (``pallas``), the plain sweep vectorised over the trials
  (``sublattice``), the draws of all trials and one arbitration over the
  stacked lattices (``batched``), S1 once per trial (``reference``);
* ``multi_mcs_batch(grids, seeds (n, K, 2), shifts (n, K, 2)) -> (grids,
  counts (n, K, S+1))``: K2 over the trials (``pallas_fused``);
* ``counts_batch(grids, species) -> (n, S+1) int32``: K4 per trial.

``sharded_pod`` is not vmappable but ``pod_composable``: its trial batch
is a ``sharded_pod.PodBatch`` over the engine's ('pod', 'rows', 'cols')
mesh, made from the trials' keys by ``init_batch``, padded to
``pod_width`` trials, and advanced by the same batch functions (K1's or
K3's table form and K4s per trial).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, NamedTuple, Optional, Tuple,
                    TYPE_CHECKING)

import torch

from . import batched as batched_mod
from . import reference as reference_mod
from . import sublattice, threefry
from .device import Devices, resolve_device, resolve_devices
from .lattice import DIRS
from .lattice import counts as _lattice_counts
from .lattice import trial_counts as _trial_counts
from .observables import observable_names
from .rng import ProposalBatch, proposal_batch, round_shift, tile_stream_batch
from .tracing import ARBITRATION, DRAWS, span

if TYPE_CHECKING:  # params validates through this module
    from .params import EscgParams


def _same(grid):
    return grid


class BuiltEngine(NamedTuple):
    """A ready-to-run engine for one (params, dominance, device)."""
    schedule: Callable[[torch.Tensor, int],
                       Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]
    one_mcs: Callable[[Any, Tuple[int, int], Tuple[int, int]],
                      Tuple[Any, torch.Tensor]]
    attempts_per_mcs: int
    device: torch.device       # where the lattice is built, counts land
    multi_mcs: Optional[Callable[[Any, torch.Tensor, torch.Tensor],
                                 Tuple[Any, torch.Tensor]]] = None
    place: Callable[[torch.Tensor], Any] = _same
    gather: Callable[[Any], torch.Tensor] = _same
    counts: Callable[[Any, int], torch.Tensor] = _lattice_counts
    # the trial batch of a vmappable engine (module docstring)
    schedule_batch: Optional[Callable[[torch.Tensor, int],
                                      Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]]] = None
    one_mcs_batch: Optional[Callable[[torch.Tensor, torch.Tensor,
                                      torch.Tensor],
                                     Tuple[torch.Tensor,
                                           torch.Tensor]]] = None
    multi_mcs_batch: Optional[Callable[[torch.Tensor, torch.Tensor,
                                        torch.Tensor],
                                       Tuple[torch.Tensor,
                                             torch.Tensor]]] = None
    counts_batch: Callable[[torch.Tensor, int], torch.Tensor] = _trial_counts
    # the composed pod x grid mesh (sharded_pod): the trials per launch
    # unit come in multiples of pod_width, init_batch(trial keys (n, 2)) ->
    # (the batch on the mesh, run keys (n, 2) on the host)
    pod_width: int = 1
    init_batch: Optional[Callable[[torch.Tensor],
                                  Tuple[Any, torch.Tensor]]] = None
    # the device mesh of a multi_device engine (LatticeMesh or PodMesh)
    mesh: Any = None
    # one MCS's (words, shift) from its key, as ``schedule`` derives them
    # from each ``k1`` of its chain
    round_inputs: Optional[Callable[[torch.Tensor], Tuple[Any, Any]]] = None


@dataclass(frozen=True)
class EngineCaps:
    """Static capability metadata consumed by params validation."""
    flux_only: bool = False    # requires periodic (torus) boundaries
    tiled: bool = False        # consumes params.tile; tile must divide grid
    multi_device: bool = False  # domain-decomposed over a device mesh
    vmappable: bool = True     # runs a batch of trials (trials.run_trials)
    trial_shardable: bool = True  # its trial batch may be split over
                               # devices (requires vmappable)
    mesh_axes: Tuple[str, ...] = ()  # the mesh axes the engine owns;
                               # ('rows', 'cols') = grid decomposition
    local_kernels: Tuple[str, ...] = ()  # the values of
                               # params.local_kernel the engine accepts;
                               # empty = the knob is ignored
    multi_mcs: bool = False    # supports params.k_mcs > 1 (the megakernel)
    equiv_oracle: Optional[str] = None  # engine this one is bit-identical
                               # to (same key -> same trajectory)
    equiv_oracles: Tuple[Tuple[str, str], ...] = ()
                               # (local_kernel, oracle) overrides: a local
                               # kernel with its own PRNG scheme belongs to
                               # another family ('fused' -> 'pallas_fused')
    description: str = ""
    paper: str = ""            # paper algorithm / figure it reproduces

    @property
    def pod_composable(self) -> bool:
        """True when the trial axis rides a ``pod`` mesh axis, the trials
        sharded over it and each lattice decomposed over ('rows',
        'cols')."""
        return "pod" in self.mesh_axes

    def oracle_for(self, local_kernel: str = "jnp") -> Optional[str]:
        """The engine this one is bit-identical to when it runs
        ``local_kernel``: ``equiv_oracles`` first, then
        ``equiv_oracle``."""
        for lk, oracle in self.equiv_oracles:
            if lk == local_kernel:
                return oracle
        return self.equiv_oracle

    @property
    def trial_axis(self) -> str:
        """Human-readable trial-axis support (engine matrix column)."""
        if self.pod_composable:
            return "pod×grid composed mesh"
        if self.vmappable and self.trial_shardable:
            return "pod-sharded vmap"
        if self.vmappable:
            return "vmap (1 device)"
        return "—"


@dataclass(frozen=True)
class EngineSpec:
    name: str
    caps: EngineCaps
    build: Callable = field(repr=False, default=None)


_REGISTRY: Dict[str, EngineSpec] = {}

# engines of the reference that this port does not run yet, with the
# ROADMAP.md item that ports each (none: every engine is ported)
NOT_PORTED: Dict[str, str] = {}


def register(name: str, caps: EngineCaps):
    """Decorator: register ``build(params, dom, device) -> BuiltEngine``."""
    def deco(build_fn):
        _REGISTRY[name] = EngineSpec(name=name, caps=caps, build=build_fn)
        return build_fn
    return deco


def engine_names() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


def engine_specs() -> Tuple[EngineSpec, ...]:
    return tuple(_REGISTRY.values())


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
    if spec.caps.multi_device and p.shard_grid is not None:
        dr, dc = p.shard_grid
        if dr < 1 or dc < 1:
            raise ValueError("shard_grid dims must be >= 1")
    if p.local_kernel not in ("jnp", "pallas", "fused"):
        raise ValueError("local_kernel must be 'jnp', 'pallas' or 'fused'")
    if spec.caps.local_kernels and \
            p.local_kernel not in spec.caps.local_kernels:
        raise ValueError(
            f"engine {p.engine!r} supports local_kernel in "
            f"{spec.caps.local_kernels}, got {p.local_kernel!r}")
    if p.k_mcs < 1:
        raise ValueError(f"k_mcs must be >= 1, got {p.k_mcs}")
    if p.k_mcs > 1 and not spec.caps.multi_mcs:
        raise ValueError(f"engine {p.engine!r} does not support k_mcs > 1")
    if p.k_mcs > 1 and spec.caps.local_kernels and p.local_kernel != "fused":
        raise ValueError(
            f"k_mcs > 1 requires local_kernel='fused' on engine "
            f"{p.engine!r} (got {p.local_kernel!r}): only the in-kernel "
            "Philox schedule can thread K MCS through one launch")
    if p.obs_capacity < 0:
        raise ValueError(f"obs_capacity must be >= 0, got {p.obs_capacity}")
    for name in p.observables:
        if name not in observable_names():
            raise ValueError(f"unknown observable {name!r}; known: "
                             f"{observable_names()}")
    if p.mesh_shape is not None:
        if not spec.caps.pod_composable:
            raise ValueError(
                f"engine {p.engine!r} does not lay devices on a "
                f"('pod','rows','cols') mesh (mesh_axes="
                f"{spec.caps.mesh_axes}); mesh_shape only applies to "
                "pod-composable engines like 'sharded_pod'")
        if len(p.mesh_shape) != len(spec.caps.mesh_axes):
            raise ValueError(
                f"mesh_shape {p.mesh_shape} must have one entry per mesh "
                f"axis {spec.caps.mesh_axes}")
        if any(d < 1 for d in p.mesh_shape):
            raise ValueError("mesh_shape dims must be >= 1")


# engines built in this process: the serving cache reads it to show that
# a repeat bucket builds nothing again
BUILDS = 0


def build(params, dom=None, device: Optional[Devices] = None
          ) -> BuiltEngine:
    """Resolve ``params.engine`` (an ``EscgParams`` or a ``Scenario``) and
    build it on ``device`` (default: the card). A ``multi_device`` engine
    takes a sequence of devices for its mesh, in raster order, and
    ``None`` means every visible card; the others take one device.
    ``dom=None`` takes the scenario's dominance network, or the circulant
    C(S, {1})."""
    from .scenarios import resolve_config  # scenarios imports this module
    params, dom = resolve_config(params, dom)
    params = params.validate()
    spec = get_engine(params.engine)
    if spec.caps.multi_device:
        where = resolve_devices(device)
        dev = where[0]
    else:
        where = dev = resolve_device(device)
    if dom is None:
        from . import dominance as dom_mod
        dom = dom_mod.circulant(params.species)
    dom = torch.as_tensor(dom, dtype=torch.float32).to(dev).contiguous()
    global BUILDS
    BUILDS += 1
    return spec.build(params, dom, where)


# --------------------------- registered engines --------------------------- #

def _pick_sub_batches(n: int) -> int:
    """Arbitration windows per MCS of ``batched``: the first of 8, 4, 2
    that divides the N proposals, else 1."""
    for d in (8, 4, 2):
        if n % d == 0:
            return d
    return 1


def _key_inputs(k1: torch.Tensor):
    return threefry.key_data(k1), 0


def _key_schedule(key: torch.Tensor, n_mcs: int):
    """The schedule of ``reference`` and ``batched``: each MCS's words are
    ``key_data(k1)``, and the shift is unused."""
    return _round_schedule(key, n_mcs, _key_inputs)


# the most proposals a trial batch draws at once: the int64 threefry of a
# draw holds several temporaries of 8 bytes a proposal, so larger batches
# draw in groups of trials
DRAW_GROUP = 1 << 24


def _trial_groups(n_trials: int, per_trial: int):
    """Slices of consecutive trials whose draws of ``per_trial`` proposals
    each fit in ``DRAW_GROUP`` together (one trial at the least)."""
    size = max(1, DRAW_GROUP // max(1, per_trial))
    return [slice(a, min(a + size, n_trials))
            for a in range(0, n_trials, size)]


@register("reference", EngineCaps(
    description="sequential oracle; one proposal at a time via lax.scan",
    paper="Algorithm 3.2/3.3 (single-threaded baseline)"))
def _build_reference(p: "EscgParams", dom: torch.Tensor,
                     device: torch.device) -> BuiltEngine:
    """Sequential oracle (E1, Algorithm 3.2/3.3, the single-threaded
    baseline): N proposals per MCS from ``proposal_batch(k1, N, N,
    nbhd)``, applied strictly in order by kernel S1 on the card."""
    t_eps, t_eps_mu = p.action_thresholds()
    n = p.n_cells

    def one_mcs(grid, words, shift):
        k1 = torch.tensor(words, dtype=torch.int64)
        batch = proposal_batch(k1, n, n, p.neighbourhood, device=grid.device)
        return reference_mod.run_proposals(grid, batch, t_eps, t_eps_mu,
                                           dom, p.flux)

    def one_mcs_batch(grids, words, shifts):
        # every trial's draws at once (by groups), then S1 once per trial
        out, kept = [], []
        for grp in _trial_groups(grids.shape[0], n):
            batch = proposal_batch(words[grp], n, n, p.neighbourhood)
            for t in range(grp.stop - grp.start):
                one = ProposalBatch(*(f[t] for f in batch))
                g, k = reference_mod.run_proposals(
                    grids[grp.start + t], one, t_eps, t_eps_mu, dom, p.flux)
                out.append(g)
                kept.append(k)
        return torch.stack(out), torch.stack(kept)

    return BuiltEngine(_key_schedule, one_mcs, attempts_per_mcs=n,
                       device=device, schedule_batch=_key_schedule,
                       one_mcs_batch=one_mcs_batch, round_inputs=_key_inputs)


@register("batched", EngineCaps(
    description="scatter-min conflict arbitration over proposal sub-batches",
    paper="Algorithm 3.5/3.6 (CUDA port, E2)"))
def _build_batched(p: "EscgParams", dom: torch.Tensor,
                   device: torch.device) -> BuiltEngine:
    """Scatter-min conflict arbitration over proposal sub-batches (E2,
    Algorithm 3.5/3.6, the paper's CUDA design): each MCS splits ``k1``
    into ``n_sub`` keys and runs one window of N / n_sub proposals per
    key through ``batched.run_proposals``."""
    t_eps, t_eps_mu = p.action_thresholds()
    n = p.n_cells
    n_sub = _pick_sub_batches(n)
    b_sub = n // n_sub

    def one_mcs(grid, words, shift):
        keys = threefry.split(torch.tensor(words, dtype=torch.int64), n_sub)
        kept = []
        for k in keys:
            batch = proposal_batch(k, b_sub, n, p.neighbourhood,
                                   device=grid.device)
            grid, k_sub = batched_mod.run_proposals(grid, batch, t_eps,
                                                    t_eps_mu, dom, p.flux)
            kept.append(k_sub)
        return grid, torch.stack(kept).sum(dtype=torch.int32)

    def one_mcs_batch(grids, words, shifts):
        # every trial's window keys and draws at once (by groups of
        # trials), each window arbitrated over the stacked lattices
        keys = threefry.split_batch(words, n_sub)
        out, kept = [], []
        for grp in _trial_groups(grids.shape[0], b_sub):
            g, k_grp = grids[grp], 0
            for j in range(n_sub):
                with span(DRAWS):
                    batch = proposal_batch(keys[grp, j], b_sub, n,
                                           p.neighbourhood)
                with span(ARBITRATION):
                    g, k_sub = batched_mod.run_proposals_trials(
                        g, batch, t_eps, t_eps_mu, dom, p.flux)
                k_grp = k_grp + k_sub
            out.append(g)
            kept.append(k_grp)
        return torch.cat(out), torch.cat(kept)

    return BuiltEngine(_key_schedule, one_mcs, attempts_per_mcs=n,
                       device=device, schedule_batch=_key_schedule,
                       one_mcs_batch=one_mcs_batch, round_inputs=_key_inputs)


def _tiled_setup(p: "EscgParams"):
    """Tile bookkeeping of the sublattice-family engines."""
    th, tw = p.tile
    n_tiles = (p.height // th) * (p.length // tw)
    k_per_tile = max(1, math.ceil(p.n_cells / n_tiles))
    interior = (th - 2) * (tw - 2)
    return th, tw, n_tiles, k_per_tile, interior


def fused_round_inputs(key: torch.Tensor, th: int, tw: int):
    """Per-MCS (Philox seed words, window shift) of the fused-PRNG family:
    seed = the raw key words, shift keyed by ``fold_in(key, 1)``. Keys (n,
    2) give the inputs of each, (n, 2) and (n, 2)."""
    if key.dim() == 2:
        return key, round_shift(threefry.fold_in_batch(key, 1), th, tw)
    seed = threefry.key_data(key)[-2:]
    shift = round_shift(threefry.fold_in(key, 1), th, tw)
    return seed, shift


def _round_schedule(key: torch.Tensor, n_mcs: int, round_inputs):
    """Replay the MCS loop's key chain ``key, k1 = split(key)`` ``n_mcs``
    times with ``round_inputs(k1) -> (words (2,), shift (2,))``; returns
    ``(key', words (n, 2), shifts (n, 2))``, int64 on the host. A batch of
    keys (n, 2), one per trial, runs every chain at once with the batched
    threefry (``round_inputs`` then takes and gives (n, 2)) and gives
    ``(keys', words (n, n_mcs, 2), shifts (n, n_mcs, 2))``."""
    words = torch.zeros(key.shape[:-1] + (n_mcs, 2), dtype=torch.int64)
    shifts = torch.zeros_like(words)
    for t in range(n_mcs):
        if key.dim() == 2:
            both = threefry.split_batch(key)
            key, k1 = both[:, 0], both[:, 1]
        else:
            key, k1 = threefry.split(key)
        words[..., t, :], shifts[..., t, :] = round_inputs(k1)
    return key, words, shifts


def multi_round_inputs(key: torch.Tensor, th: int, tw: int, k_steps: int):
    """The K-step fused schedule ``(key', seeds (K, 2), shifts (K, 2))``,
    int64 on the host. Replays the MCS loop's per-MCS key chain — ``key, k1
    = split(key); fused_round_inputs(k1)`` K times — so K steps from it
    equal K single-MCS calls, and ``key'`` is the loop's key after K
    MCS."""
    return _round_schedule(key, k_steps,
                           lambda k1: fused_round_inputs(k1, th, tw))


def tiled_round_inputs(key: torch.Tensor, th: int, tw: int):
    """Per-MCS (proposal key data, window shift) of the stream-fed engines:
    ``kp, ks = split(key)``, the tiles' streams keyed by ``kp`` and the
    shift drawn from ``ks``, as the reference's ``_build_tiled``. Keys (n,
    2) give the inputs of each, (n, 2) and (n, 2)."""
    if key.dim() == 2:
        both = threefry.split_batch(key)
        return both[:, 0], round_shift(both[:, 1], th, tw)
    kp, ks = threefry.split(key)
    return threefry.key_data(kp), round_shift(ks, th, tw)


def _build_tiled(p: "EscgParams", device: torch.device,
                 run_round: Callable, run_round_batch: Callable
                 ) -> BuiltEngine:
    """Shared build function of the stream-fed engines (plain and kernel).

    Proposals come from per-tile counter-based streams
    (``rng.tile_stream_batch``) drawn on the lattice's device, so the
    trajectory is a function of (key, tile id) only. The frame is never
    rolled back: densities and the other observables of a torus are
    translation-invariant, and the reference lets its frame drift the same
    way. A trial batch draws every trial's streams (by groups of trials
    whose int64 temporaries stay bounded, into one (n, T, K) buffer) and
    then runs ``run_round_batch`` once."""
    th, tw, n_tiles, k_per_tile, interior = _tiled_setup(p)
    tile_ids = torch.arange(n_tiles, dtype=torch.int64, device=device)
    attempts = torch.tensor(n_tiles * k_per_tile, dtype=torch.int32,
                            device=device)

    def round_inputs(k1):
        return tiled_round_inputs(k1, th, tw)

    def schedule(key, n_mcs):
        return _round_schedule(key, n_mcs, round_inputs)

    def one_mcs(grid, seed, shift):
        kp = torch.tensor(seed, dtype=torch.int64).to(grid.device)
        props = tile_stream_batch(kp, tile_ids, k_per_tile, interior,
                                  p.neighbourhood)
        return run_round(grid, props, shift), attempts

    def draw(words):
        return tile_stream_batch(words, tile_ids, k_per_tile, interior,
                                 p.neighbourhood)

    def one_mcs_batch(grids, words, shifts):
        n = grids.shape[0]
        groups = _trial_groups(n, n_tiles * k_per_tile)
        if len(groups) == 1:
            props = draw(words)
        else:
            props = ProposalBatch(*(
                torch.empty((n, n_tiles, k_per_tile), dtype=dt,
                            device=grids.device)
                for dt in (torch.int32, torch.int32, torch.float32,
                           torch.float32)))
            for grp in groups:
                for buf, part in zip(props, draw(words[grp])):
                    buf[grp] = part
        return run_round_batch(grids, props, shifts), attempts.expand(n)

    return BuiltEngine(schedule, one_mcs,
                       attempts_per_mcs=n_tiles * k_per_tile, device=device,
                       schedule_batch=schedule,
                       one_mcs_batch=one_mcs_batch, round_inputs=round_inputs)


@register("sublattice", EngineCaps(
    flux_only=True, tiled=True,
    description="shifted-window synchronous sublattice, pure jnp (E3)",
    paper="maxStep §4.2.4 redesigned for tiles (Fig 4.3)"))
def _build_sublattice(p: "EscgParams", dom: torch.Tensor,
                      device: torch.device) -> BuiltEngine:
    """Shifted-window synchronous sublattice in plain PyTorch (E3): the
    tile sweep of ``sublattice.run_round``, vectorised over tiles."""
    t_eps, t_eps_mu = p.action_thresholds()

    def run_round(grid, props, shift):
        return sublattice.run_round(grid, props, shift, p.tile, t_eps,
                                    t_eps_mu, dom, roll_back=False)

    def run_round_batch(grids, props, shifts):
        return sublattice.run_round_trials(grids, props, shifts, p.tile,
                                           t_eps, t_eps_mu, dom)

    return _build_tiled(p, device, run_round, run_round_batch)


@register("pallas", EngineCaps(
    flux_only=True, tiled=True, equiv_oracle="sublattice",
    description="sublattice round as a Pallas TPU kernel (VMEM-resident)",
    paper="maxStep §4.2.4, kernelized (Fig 4.3)"))
def _build_pallas(p: "EscgParams", dom: torch.Tensor,
                  device: torch.device) -> BuiltEngine:
    """The sublattice round as the CUDA kernel K3: one-warp blocks that
    stage 32 tiles each in shared memory, with the roll fused into the
    tile load and the proposals streamed in through shared memory."""
    from ..kernels import ops as kernel_ops  # kernels import core modules
    t_eps, t_eps_mu = p.action_thresholds()
    dirs = torch.as_tensor(DIRS, dtype=torch.int32).to(device)

    def run_round(grid, props, shift):
        return kernel_ops.escg_round(grid, props, shift, dom, dirs, p.tile,
                                     t_eps, t_eps_mu, roll_back=False)

    def run_round_batch(grids, props, shifts):
        return kernel_ops.escg_round_trials(grids, props, shifts, dom, dirs,
                                            p.tile, t_eps, t_eps_mu)

    return _build_tiled(p, device, run_round, run_round_batch)


@register("pallas_fused", EngineCaps(
    flux_only=True, tiled=True, multi_mcs=True,
    description="Pallas kernel with in-kernel Philox proposal derivation "
                "(zero proposal HBM traffic)",
    paper="numRandoms buffer §3.2.1 eliminated (Fig 4.2)"))
def _build_pallas_fused(p: "EscgParams", dom: torch.Tensor,
                        device: torch.device) -> BuiltEngine:
    """Sublattice sweep with in-kernel Philox proposals (the paper's
    numRandoms buffer of §3.2.1 eliminated): CUDA kernel K1 for one MCS,
    K2 for k_mcs MCS per launch."""
    from ..kernels import ops as kernel_ops  # kernels import core modules
    t_eps, t_eps_mu = p.action_thresholds()
    th, tw, n_tiles, k_per_tile, _ = _tiled_setup(p)
    dirs = torch.as_tensor(DIRS, dtype=torch.int32).to(device)
    attempts = torch.tensor(n_tiles * k_per_tile, dtype=torch.int32,
                            device=device)

    def schedule(key, n_mcs):
        return multi_round_inputs(key, th, tw, n_mcs)

    def one_mcs(grid, seed, shift):
        return kernel_ops.escg_round_fused(
            grid, seed, 0, shift, dom, dirs, p.tile, k_per_tile, t_eps,
            t_eps_mu, p.neighbourhood, roll_back=False), attempts

    def one_mcs_batch(grids, seeds, shifts):
        return kernel_ops.escg_round_fused_trials(
            grids, seeds, shifts, dom, dirs, p.tile, k_per_tile, t_eps,
            t_eps_mu, p.neighbourhood), attempts.expand(grids.shape[0])

    def multi_mcs(grid, seeds, shifts):
        return kernel_ops.escg_rounds_fused(
            grid, seeds, shifts, dom, dirs, p.tile, k_per_tile, t_eps,
            t_eps_mu, p.species, p.neighbourhood)

    def multi_mcs_batch(grids, seeds, shifts):
        return kernel_ops.escg_rounds_fused_trials(
            grids, seeds, shifts, dom, dirs, p.tile, k_per_tile, t_eps,
            t_eps_mu, p.species, p.neighbourhood)

    return BuiltEngine(schedule, one_mcs,
                       attempts_per_mcs=n_tiles * k_per_tile, device=device,
                       multi_mcs=multi_mcs, schedule_batch=schedule,
                       one_mcs_batch=one_mcs_batch,
                       multi_mcs_batch=multi_mcs_batch,
                       round_inputs=lambda k1: fused_round_inputs(k1, th, tw))


@register("sharded", EngineCaps(
    flux_only=True, tiled=True, multi_device=True, vmappable=False,
    trial_shardable=False, mesh_axes=("rows", "cols"),
    local_kernels=("jnp", "pallas", "fused"), multi_mcs=True,
    equiv_oracle="sublattice", equiv_oracles=(("fused", "pallas_fused"),),
    description="domain-decomposed across devices: shard_map + ppermute "
                "halo exchange, per-tile Philox streams, psum stasis counts",
    paper="size scaling beyond one device (Fig 4.3, L=3200)"))
def _build_sharded(p: "EscgParams", dom: torch.Tensor,
                   devices: Tuple[torch.device, ...]) -> BuiltEngine:
    """Domain decomposition over a ('rows', 'cols') device mesh: halo
    copies for the round's shift, then the ``local_kernel``'s round on
    every block (K1 for 'fused', K3 for 'pallas', the plain sweep for
    'jnp'), and the counts from ``density_counts_sharded``."""
    from . import sharded as sharded_mod  # sharded imports this module
    return sharded_mod.build_engine(p, dom, devices)


@register("sharded_pod", EngineCaps(
    flux_only=True, tiled=True, multi_device=True, vmappable=False,
    trial_shardable=False, mesh_axes=("pod", "rows", "cols"),
    local_kernels=("jnp", "pallas", "fused"), multi_mcs=True,
    equiv_oracle="sublattice", equiv_oracles=(("fused", "pallas_fused"),),
    description="composed trial x grid mesh: IID trials sharded over "
                "'pod', each lattice halo-exchanged over ('rows','cols'); "
                "same per-tile streams as sharded",
    paper="mass replication of large lattices (Fig 4.3 x Table 4.2)"))
def _build_sharded_pod(p: "EscgParams", dom: torch.Tensor,
                       devices: Tuple[torch.device, ...]) -> BuiltEngine:
    """IID trials over a ('pod', 'rows', 'cols') mesh, each trial's
    lattice decomposed over its pod group's ('rows', 'cols') mesh: K1's or
    K3's table form over every block of every trial of a device, K4s per
    trial; ``simulate`` runs ``sharded`` on pod group 0's grid."""
    from . import sharded_pod as pod_mod  # it imports this module
    return pod_mod.build_engine(p, dom, devices)
