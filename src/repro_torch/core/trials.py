"""IID trials on the card (port of ``repro.core.trials``, DESIGN.md §4).

The paper's replication studies are massed IID trials (Park et al. ran
2000 serial repetitions for one figure; the dissertation's Table 4.2 runs
20 per cell). The reference vmaps its engines over a leading trial axis and
shards that axis over its devices (the *pod* axis). Here the trials of a
device are n lattices stacked as one (n, H, W) tensor, and every MCS of a
device is one launch per kernel for all of them (``engines.BuiltEngine``'s
``one_mcs_batch``/``multi_mcs_batch`` and K4 per trial); the devices of the
pod each run a contiguous slice of the trials. The composed engine
``sharded_pod`` owns its ('pod', 'rows', 'cols') mesh: the whole batch
is one unit of the trial driver, each trial born on its pod group and
placed into its group's blocks (``BuiltEngine.init_batch``), one launch
per device and kernel for every block of every trial.

Invariants, as in the reference (``tests/test_torch_trials.py``):

* **Per-trial fold-in keys.** Trial ``t`` uses ``fold_in(key, t)`` with
  ``t`` the global trial index, so results do not depend on the trial
  count, the padding or the device layout, and a prefix of a larger run
  equals the smaller run. Its lattice is drawn from ``kg`` and its run
  key is ``kr`` of ``kg, kr = split(fold_in(key, t))``.
* **Padding.** ``n_trials`` is padded to a multiple of the device count
  (of the pod width for ``sharded_pod``); padded trials run and are
  dropped from every statistic on the host.
* **Chunked streaming.** A chunk of MCS runs on the devices without a host
  decision: its key chain of every trial is computed on the host at once
  with the batched threefry (``schedule_batch``) and copied to the device
  once; the host sees the per-MCS alive-species masks, the final counts,
  the kept counts and the observable ring once per chunk.
* **Async statistics.** With ``async_stats`` chunk k's outputs are copied
  to pinned host memory and an event is recorded before chunk k+1 is
  enqueued, so the host's accounting of chunk k overlaps chunk k+1 on the
  card. The result is bit-identical to ``async_stats=False``: a
  speculative chunk past an early exit is dropped unread.
* **Chunked stasis early exit.** Stasis (<= 1 species alive) and
  extinctions are recorded per MCS from the masks, but the driver stops
  only at a chunk boundary, once every real trial is in stasis.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import dominance as dom_mod
from . import engines, lattice, threefry
from . import observables as obs_mod
from .device import Devices, resolve_device, resolve_devices
from .params import EscgParams
from .results import decode_observables, encode_observables


# ------------------------------ TrialResult ------------------------------- #

@dataclass
class TrialResult:
    """Streamed statistics of a batch of IID trials. Grids are absent: the
    lattices stay on the devices and only these statistics reach the host.

    ``observables`` maps the streamed observable names to per-trial
    streams flushed from the device ring, shape ``(n_trials, T, ...)``
    with T the rows the ring kept (the MCS run when its capacity covers a
    chunk; a smaller ring drops each chunk's oldest rows). Empty when
    ``params.observables`` is. ``densities`` is the final densities."""
    survival: np.ndarray       # (n_trials, S) bool: species alive at end
    densities: np.ndarray      # (n_trials, S + 1): final densities, col 0
                               # the empties
    stasis_mcs: np.ndarray     # (n_trials,): first MCS with <= 1 species
                               # alive; -1 if never
    extinction_mcs: np.ndarray  # (n_trials, S): first MCS each species
                               # hit zero; 0 = absent at init, -1 = never
    mcs_completed: int         # MCS every trial ran
    kept_fraction: float       # applied / attempted proposals
    n_trials: int
    n_devices: int             # the devices the batch ran on (pod width)
    observables: dict = field(default_factory=dict)

    @property
    def species(self) -> int:
        return self.survival.shape[1]

    def survival_probabilities(self) -> np.ndarray:
        """Per-species survival probability, shape (S,)."""
        return self.survival.mean(axis=0)

    def survivors_hist(self) -> np.ndarray:
        """Histogram over the number of surviving species, shape (S + 1,),
        summing to 1."""
        s = self.species
        return (np.bincount(self.survival.sum(axis=1).astype(np.int64),
                            minlength=s + 1)[:s + 1] / self.n_trials)

    def extinction_probability(self, sp: int) -> float:
        """P(species ``sp``, 1-indexed, extinct at the end)."""
        return float(1.0 - self.survival[:, sp - 1].mean())

    def mean_densities(self) -> np.ndarray:
        return self.densities.mean(axis=0)

    def to_json(self) -> str:
        return json.dumps({
            "survival": self.survival.astype(int).tolist(),
            "densities": self.densities.tolist(),
            "stasis_mcs": self.stasis_mcs.tolist(),
            "extinction_mcs": self.extinction_mcs.tolist(),
            "mcs_completed": self.mcs_completed,
            "kept_fraction": self.kept_fraction,
            "n_trials": self.n_trials,
            "n_devices": self.n_devices,
            "observables": encode_observables(self.observables),
        })

    @staticmethod
    def from_json(s: str) -> "TrialResult":
        d = json.loads(s)
        return TrialResult(
            survival=np.asarray(d["survival"], dtype=bool),
            densities=np.asarray(d["densities"], dtype=np.float64),
            stasis_mcs=np.asarray(d["stasis_mcs"], dtype=np.int64),
            extinction_mcs=np.asarray(d["extinction_mcs"], dtype=np.int64),
            mcs_completed=int(d["mcs_completed"]),
            kept_fraction=float(d["kept_fraction"]),
            n_trials=int(d["n_trials"]),
            n_devices=int(d["n_devices"]),
            observables=decode_observables(d.get("observables", {})),
        )


# ------------------------------- the pod axis ------------------------------ #

POD_AXIS = "pod"   # the trial axis's name in a mesh (launch.mesh)


def pod_devices(device: Optional[Devices] = None,
                trial_devices: Optional[int] = None
                ) -> Tuple[torch.device, ...]:
    """The devices of the pod, in order: ``device`` is one device or a
    sequence (which may repeat one, as ``["cpu"] * 3``), ``None`` every
    visible card; ``trial_devices=d`` keeps the first d."""
    devs = resolve_devices(device)
    if trial_devices is None:
        return devs
    d = int(trial_devices)
    if d < 1:
        raise ValueError("trial_devices must be >= 1")
    if d > len(devs):
        raise ValueError(f"trial_devices={d} but only {len(devs)} "
                         "devices are available")
    return devs[:d]


def pad_trials(n_trials: int, n_devices: int) -> int:
    """Smallest multiple of ``n_devices`` that is >= ``n_trials``."""
    return -(-n_trials // n_devices) * n_devices


def fold_trial_keys(key: torch.Tensor, n: int, start: int = 0
                    ) -> torch.Tensor:
    """Per-trial keys ``fold_in(key, t)`` for the global trial indices
    ``start .. start + n - 1``, (n, 2) int64 on the host."""
    return threefry.fold_in_batch(
        key.cpu(), torch.arange(start, start + n, dtype=torch.int64))


def make_trial_init(p: EscgParams, device=None):
    """``init(trial_keys (n, 2)) -> (grids (n, H, W) on device, run keys
    (n, 2) on the host)``: trial t's lattice is drawn from ``kg`` in
    ``params.cell_dtype`` and its run key is ``kr``, ``kg, kr =
    split(trial_keys[t])``. This is not ``simulate(key=trial_key)``,
    which keeps the first half of its split for the chain: a trial equals
    ``simulate(grid0=<the lattice from kg>, key=kr)``."""
    cell_dt = getattr(torch, p.cell_dtype)
    dev = resolve_device(device)

    def init(trial_keys: torch.Tensor):
        both = threefry.split_batch(trial_keys.cpu())
        grids = torch.empty((trial_keys.shape[0], p.height, p.length),
                            dtype=cell_dt, device=dev)
        for t, kg in enumerate(both[:, 0]):
            grids[t] = lattice.init_grid(kg, p.height, p.length, p.species,
                                         p.empty, dtype=cell_dt, device=dev)
        return grids, both[:, 1].clone()

    return init


def trial_grids_and_keys(p: EscgParams, key: torch.Tensor, n_pad: int,
                         device=None):
    """Initial lattices (on ``device``) and run keys (on the host) of the
    trials 0 .. n_pad - 1 of ``key``."""
    return make_trial_init(p, device)(fold_trial_keys(key, n_pad))


# ----------------------------- chunked driver ------------------------------ #

def build_trial_chunk(p: EscgParams, built: engines.BuiltEngine,
                      pipe: Optional[obs_mod.ObsPipeline] = None):
    """``chunk(grids, keys, n_mcs) -> (grids, keys, final_counts (n, S+1),
    alive (n, n_mcs, S) bool, kept (n,), attempts (n,))`` for the trial
    batch of ``built``'s device: the counts, masks and kept counts on the
    device, the keys on the host.

    The chunk's key chain of every trial is one host computation
    (``schedule_batch``) copied to the device once; then each MCS is one
    ``one_mcs_batch`` and one K4 per trial, or with ``k_mcs > 1`` each
    group of MCS one ``multi_mcs_batch``. The kept counts are summed per
    trial on the device.

    With ``pipe`` the chunk also returns the per-MCS observable rows, (n_mcs,
    n, width); under ``k_mcs > 1`` the grid-derived slices are lag-held at
    launch-group starts as in ``simulation.build_obs_chunk_fn``."""
    if built.one_mcs_batch is None:
        raise ValueError(f"engine {p.engine!r} runs no trial batch")
    s = p.species
    k_group = p.k_mcs

    def chunk(grids, keys, n_mcs: int):
        if n_mcs < 1:
            raise ValueError(f"a chunk runs at least one MCS, got {n_mcs}")
        n = keys.shape[0]
        keys, words, shifts = built.schedule_batch(keys, n_mcs)
        sched = torch.stack([words, shifts]).to(built.device)
        att = torch.full((n,), n_mcs * built.attempts_per_mcs,
                         dtype=torch.int64)
        cnts, rows = [], []
        if k_group > 1:
            held = pipe.grid_values(grids) if pipe is not None else None
            q, r = divmod(n_mcs, k_group)
            start = 0
            for size in [k_group] * q + ([r] if r else []):
                stop = start + size
                grids, c = built.multi_mcs_batch(
                    grids, sched[0, :, start:stop].contiguous(),
                    sched[1, :, start:stop].contiguous())
                cnts.append(c)
                if pipe is not None:
                    rows.append(pipe.row_held(c.transpose(0, 1), held))
                    held = pipe.grid_values(grids)
                start = stop
            kept = att.to(built.device)        # the megakernel drops nothing
        else:
            sched = sched.transpose(1, 2).contiguous()   # (2, n_mcs, n, 2)
            kept_parts = []
            for m in range(n_mcs):
                grids, kept_m = built.one_mcs_batch(grids, sched[0, m],
                                                    sched[1, m])
                c = built.counts_batch(grids, s)
                kept_parts.append(kept_m)
                cnts.append(c[:, None])
                if pipe is not None:
                    rows.append(pipe.row(grids, c)[None])
            kept = torch.stack(kept_parts).sum(dim=0, dtype=torch.int64)
        cnts = torch.cat(cnts, dim=1)                # (n, n_mcs, S + 1)
        out = (grids, keys, cnts[:, -1], cnts[:, :, 1:] > 0, kept, att)
        if pipe is not None:
            out += (torch.cat(rows, dim=0),)         # (n_mcs, n, width)
        return out

    return chunk


def build_trial_obs_chunk(p: EscgParams, built: engines.BuiltEngine):
    """Observable-pipeline trial chunk: ``chunk(grids, keys, ring, pos,
    n_mcs) -> (grids, keys, ring, pos, final_counts, alive, kept,
    attempts)``; returns ``(chunk, pipeline)``. The rows go into the
    device ring ``(capacity, n, width)``; a capacity below the chunk
    drops the oldest rows (the statistics come from ``alive``)."""
    pipe = obs_mod.build_pipeline(p)
    inner = build_trial_chunk(p, built, pipe)

    def chunk(grids, keys, ring, pos, n_mcs: int):
        grids, keys, cnts, alive, kept, att, rows = inner(grids, keys, n_mcs)
        ring, pos = obs_mod.ring_push_many(ring, pos, rows)
        return grids, keys, ring, pos, cnts, alive, kept, att

    return chunk, pipe


def _first_true_mcs(mask: np.ndarray, offset: int) -> np.ndarray:
    """First 1-based MCS index of a True along axis 1 of ``mask`` (trials
    first), offset by the MCS already completed; -1 where the event does
    not happen in this chunk."""
    hit = mask.any(axis=1)
    first = mask.argmax(axis=1) + offset + 1
    return np.where(hit, first, -1)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` on the host: into pinned memory without waiting for
    a card (the caller records an event after it), a clone on the CPU."""
    if t.device.type == "cpu":
        return t.clone()
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    return out


class _Pod:
    """One unit of the trial driver: a device's slice of the trials, or
    the whole batch of a composed mesh; its engine, chunk and state."""

    def __init__(self, p: EscgParams, built: engines.BuiltEngine,
                 trial_keys: torch.Tensor, obs_rows: int):
        self.device = built.device
        self.built = built
        init = built.init_batch or make_trial_init(p, built.device)
        self.grids, self.keys = init(trial_keys)
        self.ring = self.pos = None
        if obs_rows:
            self.chunk, self.pipe = build_trial_obs_chunk(p, self.built)
            self.ring, self.pos = obs_mod.ring_init(
                obs_rows, (trial_keys.shape[0], self.pipe.width),
                self.device)
        else:
            self.chunk, self.pipe = build_trial_chunk(p, self.built), None

    def dispatch(self, m: int):
        """Enqueue a chunk of ``m`` MCS and the copies of its outputs to
        the host; returns them and the event that marks them done."""
        if self.pipe is not None:
            (self.grids, self.keys, self.ring, self.pos, cnts, alive, kept,
             att) = self.chunk(self.grids, self.keys, self.ring, self.pos, m)
        else:
            self.grids, self.keys, cnts, alive, kept, att = self.chunk(
                self.grids, self.keys, m)
        outs = [alive, cnts, kept, att]
        if self.ring is not None:
            outs.append(self.ring)
        host = [_to_host(t) for t in outs]
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        return host, event


def _collect(pending):
    """The host copies of one chunk of every device, joined over the
    trial axis: (alive, counts, kept, attempts, ring or None)."""
    for _, event in pending:
        if event is not None:
            event.synchronize()
    parts = list(zip(*(host for host, _ in pending)))
    alive, cnts, kept, att = (np.concatenate([t.numpy() for t in part])
                              for part in parts[:4])
    rings = [t.numpy() for t in parts[4]] if len(parts) > 4 else None
    return alive, cnts, kept, att, rings


def run_trials(params, dom: Optional[np.ndarray] = None,
               n_trials: int = 1, key: Optional[torch.Tensor] = None,
               n_mcs: Optional[int] = None,
               trial_devices: Optional[int] = None,
               chunk_mcs: Optional[int] = None,
               stop_on_stasis: bool = True,
               hooks: Sequence[Callable[[int, np.ndarray], None]] = (),
               async_stats: bool = True,
               engine_config=None, run_config=None, *,
               engine=None, run=None,
               device: Optional[Devices] = None) -> TrialResult:
    """Run ``n_trials`` IID simulations, a batch per device of the pod.

    ``run_trials(scenario, n_trials=..., engine=EngineConfig(...),
    run=RunConfig(...))``; ``dom=None`` takes the scenario's dominance
    network, and its declared observables stream through the device ring
    unless ``run.observables`` pins the set. The flat form ``run_trials(
    params, dom, ...)`` still works behind a ``DeprecationWarning``
    (``engine_config=``/``run_config=`` are the older spellings of
    ``engine=``/``run=``).

    ``device`` is one device or a sequence of them in pod order (``None``:
    every visible card; ``device='cpu'`` runs the plain path), and
    ``trial_devices=d`` keeps the first d. The batch is padded to a
    multiple of the pod width, each device runs its contiguous slice of
    the trials, one launch per kernel and MCS for the slice. The composed
    engine ``sharded_pod`` lays ``device`` (raster order, entries may
    repeat) on its ('pod', 'rows', 'cols') mesh of ``params.mesh_shape``
    and refuses ``trial_devices``; the batch is padded to the pod width and
    pod group g runs trials g·n .. g·n + n - 1, each decomposed over the
    group's blocks. The trials run in chunks of
    ``chunk_mcs`` MCS (default ``params.chunk_mcs``). Between chunks the
    host folds the alive masks into per-trial stasis and extinction
    statistics and, with ``stop_on_stasis``, stops once every trial is in
    stasis. ``hooks`` get ``(mcs_done, alive_counts)`` after every chunk,
    ``alive_counts`` the (n_trials,) number of species alive.
    ``async_stats`` keeps the next chunk enqueued while the host folds
    the current one (module docstring); the results do not depend on it,
    on the pod layout, on the padding or on the chunking.
    """
    from .scenarios import resolve_config  # scenarios imports this layer
    from .simulation import _resolve_call_form
    engine_config, run_config = _resolve_call_form(
        "run_trials", params, engine_config, run_config, engine, run)
    params, dom = resolve_config(params, dom, engine_config, run_config)
    p = params.validate()
    spec = engines.get_engine(p.engine)
    composed = spec.caps.pod_composable
    if composed:
        if trial_devices is not None:
            raise ValueError(
                f"engine {p.engine!r} lays devices on a composed "
                "('pod','rows','cols') mesh — set the pod width through "
                "params.mesh_shape, not trial_devices")
    elif not spec.caps.vmappable:
        raise ValueError(
            f"engine {p.engine!r} is not vmappable (multi-device engines "
            "decompose one lattice); run IID trials with a single-device "
            "engine and shard the trial axis, or compose the two axes "
            "with engine='sharded_pod' (mesh_shape=(pod, rows, cols))")
    else:
        devices = pod_devices(device, trial_devices)
        if not spec.caps.trial_shardable and len(devices) > 1:
            raise ValueError(f"engine {p.engine!r} does not support "
                             "trial-axis sharding; use one device")
    if n_trials < 1:
        raise ValueError("n_trials must be >= 1")
    if dom is None:
        dom = dom_mod.circulant(p.species)
    if key is None:
        key = threefry.PRNGKey(p.seed)
    n_mcs = int(n_mcs if n_mcs is not None else p.mcs)
    if chunk_mcs is not None and chunk_mcs < 1:
        raise ValueError("chunk_mcs must be >= 1")
    # n_mcs == 0 is legal: no chunk runs and the result is the initial state
    chunk_len = int(chunk_mcs if chunk_mcs is not None
                    else max(1, min(p.chunk_mcs, n_mcs)))

    obs_rows = (obs_mod.ring_capacity(p, max(1, chunk_len))
                if p.observables else 0)
    if composed:
        # the engine owns the mesh; only the padding to its pod width is here
        built = engines.build(p, dom, device)
        n_dev = len(built.mesh.flat)
        n_pad = pad_trials(n_trials, built.pod_width)
        pods: List[_Pod] = [_Pod(p, built, fold_trial_keys(key, n_pad),
                                 obs_rows)]
    else:
        n_dev = len(devices)
        n_pad = pad_trials(n_trials, n_dev)
        per = n_pad // n_dev
        trial_keys = fold_trial_keys(key, n_pad)
        pods = [_Pod(p, engines.build(p, dom, d),
                     trial_keys[i * per:(i + 1) * per], obs_rows)
                for i, d in enumerate(devices)]

    s = p.species
    # species absent at initialization count as extinct at MCS 0
    init_cnts = np.concatenate([
        pod.built.counts_batch(pod.grids, s).cpu().numpy() for pod in pods])
    ext = np.where(init_cnts[:, 1:] > 0, -1, 0).astype(np.int64)
    stasis = np.full(n_pad, -1, np.int64)
    surv = init_cnts[:, 1:] > 0
    final_cnts = init_cnts
    kept_tot = att_tot = 0
    done = 0
    rows_all = []

    def dispatch(m):
        return [pod.dispatch(m) for pod in pods]

    # One chunk is kept in flight ahead of the host (async_stats): the
    # collect below waits for the chunk being folded while its successor
    # is already enqueued. At a stasis early exit the successor is dropped
    # unread, so the statistics do not depend on the schedule.
    m = min(chunk_len, n_mcs)
    pending = dispatch(m) if n_mcs else None
    while pending is not None:
        m_next = min(chunk_len, n_mcs - done - m)
        ahead = dispatch(m_next) if m_next and async_stats else None
        alive_h, cnts_h, kept_h, att_h, rings = _collect(pending)
        if rings is not None:
            rows_all.append(np.concatenate(
                [obs_mod.ring_flush(r, done, done + m) for r in rings],
                axis=1))
        final_cnts = cnts_h
        kept_tot += int(kept_h[:n_trials].sum())
        att_tot += int(att_h[:n_trials].sum())

        first_dead = _first_true_mcs(~alive_h, done)     # (n_pad, S)
        ext = np.where((ext < 0) & (first_dead > 0), first_dead, ext)
        first_stasis = _first_true_mcs(alive_h.sum(axis=2) <= 1, done)
        stasis = np.where((stasis < 0) & (first_stasis > 0), first_stasis,
                          stasis)
        surv = alive_h[:, -1, :]
        done += m
        for hook in hooks:
            hook(done, surv[:n_trials].sum(axis=1))
        if stop_on_stasis and (stasis[:n_trials] >= 0).all():
            break
        if m_next and ahead is None:                 # async_stats=False
            ahead = dispatch(m_next)
        pending, m = ahead, m_next

    observables = {}
    if rows_all:
        rows = np.concatenate(rows_all, axis=0)      # (T, n_pad, W)
        observables = pods[0].pipe.split(np.moveaxis(rows, 0, 1)[:n_trials])

    return TrialResult(
        survival=surv[:n_trials].astype(bool),
        densities=final_cnts[:n_trials] / p.n_cells,
        stasis_mcs=stasis[:n_trials],
        extinction_mcs=ext[:n_trials],
        mcs_completed=done,
        kept_fraction=(kept_tot / att_tot) if att_tot else 1.0,
        n_trials=n_trials,
        n_devices=n_dev,
        observables=observables,
    )
