"""Packed batch executor (port of ``repro.serve.executor``, DESIGN.md §12):
many requests, one device batch.

``run_packed`` advances every request of one (bucket, scenario) group in
a single trial batch. Bit-identity with a direct ``trials.run_trials``
call — the serving contract — falls out of three invariants of the trial
driver plus one scheduling rule:

* per-trial keys are ``fold_in(PRNGKey(seed), local_index)``, a pure
  function of the request's own seed — packing neighbours cannot perturb
  a trajectory (``core/trials.py`` module docstring);
* trajectories and per-MCS alive masks do not depend on the chunk
  schedule — only *where the host looks* depends on chunk boundaries, and
  all statistics here are per-MCS precise with explicit offsets;
* observable rows do not depend on when the ring is flushed, capacity
  permitting (DESIGN.md §11) — the admission rail rejects capacities
  below a request's effective chunk, so no packing schedule wraps the
  ring.

The scheduling rule: each request ``j`` owns the boundary set its direct
run would visit — multiples of ``eff_j = max(1, min(chunk_mcs, mcs_j))``
capped at ``mcs_j`` — and the batch always advances to the NEAREST
boundary over the active requests. A request's stasis early exit and its
``mcs_completed`` are evaluated only at its own boundaries, so both
reproduce the direct run exactly; between its boundaries the request
merely rides along (per-MCS stats are unaffected). The step size is
therefore ``<= min(eff_j)`` over active requests, which bounds every
ring flush below each request's capacity rail.

The reference's ``NamedSharding`` placements become the port's device
lists: a trial batch runs as *units*, one per device of the pod
(``trials.pod_devices``, each a contiguous slice of the padded trials, as
``run_trials`` lays them out), or one unit for the whole ('pod', 'rows',
'cols') mesh of ``sharded_pod`` (its ``init_batch`` places each group's
trials into its blocks). Each unit is one launch per kernel and MCS for
its trials, its counts K4 per trial (K4s per trial on the mesh).

``run_single`` is the same contract for the engine that cannot batch
trials (``sharded``): it runs ``simulation.simulate``'s own loop
(``simulation.run_built``) over the entry's built engine and chunk.
"""
from __future__ import annotations

from bisect import bisect_right
from dataclasses import dataclass, field as dc_field
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, \
    Tuple

import numpy as np
import torch

from ..core import engines, threefry
from ..core import observables as obs_mod
from ..core.device import Devices
from ..core.params import EscgParams
from ..core.simulation import (SimResult, build_chunk_fn, build_obs_chunk_fn,
                               run_built)
from ..core.trials import (TrialResult, _first_true_mcs, build_trial_chunk,
                           build_trial_obs_chunk, fold_trial_keys,
                           make_trial_init, pad_trials, pod_devices)
from .bucketing import Pending
from .cache import BuiltEntry

__all__ = ["Unit", "engine_kind", "effective_chunk", "build_entry",
           "run_packed", "run_single"]

EmitFn = Callable[[Pending, Dict], None]


class Unit(NamedTuple):
    """One device's share of a trial batch (or a whole pod mesh):
    ``init(trial keys) -> (grids, run keys)`` and its trial chunk."""
    built: engines.BuiltEngine
    init: Callable
    chunk: Callable


def engine_kind(engine: str) -> str:
    """Execution path of an engine: ``'pod'`` (composed pod x grid mesh),
    ``'vmap'`` (a batch of trials per device) or ``'single'`` (one
    lattice at a time — the multi-device engine ``sharded``)."""
    caps = engines.get_engine(engine).caps
    if caps.pod_composable:
        return "pod"
    if caps.vmappable:
        return "vmap"
    return "single"


def effective_chunk(p: EscgParams, n_mcs: int) -> int:
    """The chunk length a direct driver run would use (run_trials and
    simulate both clamp the configured chunk to the MCS budget)."""
    return max(1, min(p.chunk_mcs, n_mcs))


def _unit(p: EscgParams, built: engines.BuiltEngine) -> Unit:
    init = built.init_batch or make_trial_init(p, built.device)
    if p.observables:
        chunk, _ = build_trial_obs_chunk(p, built)
    else:
        chunk = build_trial_chunk(p, built)
    return Unit(built, init, chunk)


def build_entry(p: EscgParams, dom: np.ndarray,
                device: Optional[Devices] = None) -> BuiltEntry:
    """Build the reusable state of one (bucket, scenario) on ``device``
    (the server's: one device or a list, ``None`` every visible card):
    the engines, their chunks and init closures — everything a batch
    needs but the per-request seeds and budgets."""
    kind = engine_kind(p.engine)
    pipe = obs_mod.build_pipeline(p) if p.observables else None

    if kind == "pod":
        built = engines.build(p, dom, device)
        return BuiltEntry(
            key=None, params=p, dom=np.asarray(dom), kind=kind,
            units=(_unit(p, built),), pipe=pipe,
            pod_width=built.pod_width, n_devices=len(built.mesh.flat))

    if kind == "vmap":
        caps = engines.get_engine(p.engine).caps
        devs = pod_devices(device, None if caps.trial_shardable else 1)
        units = tuple(_unit(p, engines.build(p, dom, d)) for d in devs)
        return BuiltEntry(
            key=None, params=p, dom=np.asarray(dom), kind=kind,
            units=units, pipe=pipe, pod_width=len(devs),
            n_devices=len(devs))

    built = engines.build(p, dom, device)
    if p.observables:
        chunk_fn, pipe = build_obs_chunk_fn(p, built)
    else:
        chunk_fn = build_chunk_fn(p, built)
    return BuiltEntry(
        key=None, params=p, dom=np.asarray(dom), kind="single",
        chunk_fn=chunk_fn, pipe=pipe, built=built)


# ----------------------------- packed batches ------------------------------ #

@dataclass
class _JobState:
    """Host-side streamed statistics of one request inside the batch —
    the per-request mirror of the accumulators of run_trials."""
    pend: Pending
    sl: slice                    # this request's rows in the batch
    n: int
    n_mcs: int
    eff: int
    boundaries: List[int]        # ascending: direct-run chunk boundaries
    ext: np.ndarray
    stasis: np.ndarray
    surv: np.ndarray
    final_cnts: np.ndarray
    rows: List[np.ndarray] = dc_field(default_factory=list)
    kept: int = 0
    att: int = 0
    frozen_at: int = -1          # mcs_completed once finished

    def next_boundary(self, done: int) -> int:
        return self.boundaries[bisect_right(self.boundaries, done)]


def _job_boundaries(eff: int, n_mcs: int) -> List[int]:
    bs = list(range(eff, n_mcs, eff))
    bs.append(n_mcs)
    return bs


def _host(parts: Sequence[torch.Tensor], axis: int = 0) -> np.ndarray:
    """The units' tensors on the host, joined over the trial axis."""
    return np.concatenate([t.cpu().numpy() for t in parts], axis=axis)


def run_packed(entry: BuiltEntry, pends: Sequence[Pending],
               emit: Optional[EmitFn] = None
               ) -> List[Tuple[Pending, TrialResult]]:
    """Run one packed batch; one ``TrialResult`` per request, each
    bit-identical to ``run_trials(req.scenario, req.n_trials, ...)``."""
    p = entry.params
    pipe = entry.pipe
    obs_on = pipe is not None
    s = p.species

    states: List[_JobState] = []
    off = 0
    for pend in pends:
        n = max(1, pend.req.n_trials)
        n_mcs = pend.n_mcs
        eff = effective_chunk(p, n_mcs)
        states.append(_JobState(
            pend=pend, sl=slice(off, off + n), n=n, n_mcs=n_mcs, eff=eff,
            boundaries=_job_boundaries(eff, n_mcs) if n_mcs else [],
            ext=np.zeros(0), stasis=np.zeros(0), surv=np.zeros(0),
            final_cnts=np.zeros(0)))
        off += n
    total = off
    n_pad = pad_trials(total, entry.pod_width)

    blocks = [fold_trial_keys(threefry.PRNGKey(js.pend.params.seed), js.n)
              for js in states]
    if n_pad > total:
        # padding trials run like any other and are dropped, as in
        # run_trials' own padding
        blocks.append(fold_trial_keys(threefry.PRNGKey(0), n_pad - total))
    trial_keys = torch.cat(blocks)
    units = entry.units
    per = n_pad // len(units)
    grids, keys = [], []
    for i, u in enumerate(units):
        g, k = u.init(trial_keys[i * per:(i + 1) * per])
        grids.append(g)
        keys.append(k)

    init_cnts = _host([u.built.counts_batch(g, s)
                       for u, g in zip(units, grids)])
    for js in states:
        ic = init_cnts[js.sl]
        js.ext = np.where(ic[:, 1:] > 0, -1, 0).astype(np.int64)
        js.stasis = np.full(js.n, -1, np.int64)
        js.surv = ic[:, 1:] > 0
        js.final_cnts = ic
        if js.n_mcs == 0:
            js.frozen_at = 0

    rings = poss = None
    if obs_on:
        effs = [js.eff for js in states if js.frozen_at < 0]
        cap = obs_mod.ring_capacity(p, max(effs, default=1))
        rings, poss = [], []
        for u in units:
            r, q = obs_mod.ring_init(cap, (per, pipe.width), u.built.device)
            rings.append(r)
            poss.append(q)

    done = 0
    active = [js for js in states if js.frozen_at < 0]
    while active:
        nxt = min(js.next_boundary(done) for js in active)
        m = nxt - done
        outs = []
        for i, u in enumerate(units):
            if obs_on:
                (grids[i], keys[i], rings[i], poss[i], cnts, alive, kept,
                 att) = u.chunk(grids[i], keys[i], rings[i], poss[i], m)
            else:
                grids[i], keys[i], cnts, alive, kept, att = u.chunk(
                    grids[i], keys[i], m)
            outs.append((alive, cnts, kept, att))
        alive_h, cnts_h, kept_h, att_h = (_host(part)
                                          for part in zip(*outs))
        rows_h = (np.concatenate([obs_mod.ring_flush(r.cpu().numpy(), done,
                                                     done + m)
                                  for r in rings], axis=1)
                  if obs_on else None)

        for js in active:
            a = alive_h[js.sl]
            js.final_cnts = cnts_h[js.sl]
            js.kept += int(kept_h[js.sl].sum())
            js.att += int(att_h[js.sl].sum())
            first_dead = _first_true_mcs(~a, done)
            js.ext = np.where((js.ext < 0) & (first_dead > 0),
                              first_dead, js.ext)
            first_st = _first_true_mcs(a.sum(axis=2) <= 1, done)
            js.stasis = np.where((js.stasis < 0) & (first_st > 0),
                                 first_st, js.stasis)
            js.surv = a[:, -1, :]
            if obs_on:
                js.rows.append(rows_h[:, js.sl, :])
            at_boundary = nxt in js.boundaries or nxt == js.n_mcs
            if at_boundary and (nxt == js.n_mcs
                                or (js.stasis >= 0).all()):
                js.frozen_at = nxt
            if emit is not None:
                ev = {"mcs": nxt,
                      "in_stasis": int((js.stasis >= 0).sum()),
                      "n_trials": js.n, "done": js.frozen_at >= 0}
                if obs_on:
                    ev["observables"] = pipe.split(
                        np.moveaxis(rows_h[:, js.sl, :], 0, 1))
                emit(js.pend, ev)
        done = nxt
        active = [js for js in active if js.frozen_at < 0]

    out = []
    for js in states:
        observables = {}
        if obs_on and js.rows:
            rows = np.concatenate(js.rows, axis=0)   # (T, n, W)
            observables = pipe.split(np.moveaxis(rows, 0, 1))
        out.append((js.pend, TrialResult(
            survival=js.surv.astype(bool),
            densities=js.final_cnts / p.n_cells,
            stasis_mcs=js.stasis,
            extinction_mcs=js.ext,
            mcs_completed=js.frozen_at,
            kept_fraction=(js.kept / js.att) if js.att else 1.0,
            n_trials=js.n,
            n_devices=entry.n_devices,
            observables=observables)))
    return out


# --------------------------- single-lattice path --------------------------- #

def run_single(entry: BuiltEntry, pend: Pending,
               emit: Optional[EmitFn] = None) -> SimResult:
    """``simulate`` of one request over the entry's built engine and
    chunk, for the engine that decomposes one lattice over devices and
    runs no trial batch; ``emit`` gets a progress event per chunk."""
    p = pend.params

    def on_chunk(mcs_done: int, stasis_mcs: int) -> None:
        emit(pend, {"mcs": mcs_done, "in_stasis": int(stasis_mcs >= 0),
                    "n_trials": 1,
                    "done": stasis_mcs >= 0 or mcs_done >= p.mcs})

    return run_built(p, entry.built, entry.chunk_fn, entry.pipe,
                     on_chunk=on_chunk if emit is not None else None)
