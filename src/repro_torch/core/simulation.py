"""Single-lattice MCS loop (port of ``repro.core.simulation``, paper
Algorithms 3.3 / 3.7).

A *chunk* of ``chunk_mcs`` MCS runs without a host decision: the per-MCS
key chain of the whole chunk is computed on the host before its launches
(it does not depend on the lattice), the lattice and the per-MCS counts
stay on the device, and the counts come back to the host once per chunk
for the stasis early-exit (paper §3.2.2) and the hooks. ``k_mcs > 1`` runs
each chunk as ``divmod(n_mcs, k_mcs)`` megakernel launches, bit-identical
to ``k_mcs = 1``.

With observables (DESIGN.md §11, ``core/observables.py``) every per-MCS
statistic, the species counts included, is banked on the device into a
ring of rows that the host copies once per chunk.
"""
from __future__ import annotations

import json
import warnings
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from . import dominance as dom_mod
from . import engines, lattice, threefry
from . import observables as obs_mod
from .device import Devices
from .params import EscgParams
from .results import decode_observables, encode_observables
from .scenarios import resolve_config

_SCENARIO_FIRST_MSG = (
    "the flat-facade call form ({fn}(params, dom, ...)) is deprecated; "
    "pass a Scenario first — {fn}(scenario, engine=EngineConfig(...), "
    "run=RunConfig(...)) — and let the registry resolve the dominance "
    "network")


def _resolve_call_form(fn_name, params, engine_config, run_config,
                       engine, run):
    """The scenario-first signature of ``trials.run_trials``: ``engine=``
    and ``run=`` are the preferred spellings of ``engine_config=`` and
    ``run_config=`` (both at once raise), and a flat ``EscgParams`` in the
    scenario slot warns with a ``DeprecationWarning``."""
    if engine is not None:
        if engine_config is not None:
            raise TypeError(f"{fn_name}: pass engine= or engine_config=, "
                            "not both")
        engine_config = engine
    if run is not None:
        if run_config is not None:
            raise TypeError(f"{fn_name}: pass run= or run_config=, "
                            "not both")
        run_config = run
    if isinstance(params, EscgParams):
        warnings.warn(_SCENARIO_FIRST_MSG.format(fn=fn_name),
                      DeprecationWarning, stacklevel=3)
    return engine_config, run_config


@dataclass
class SimResult:
    """Single-lattice run result. ``observables['densities']`` has shape
    ``(mcs_recorded + 1, S + 1)`` float64 with row 0 the initial
    lattice."""
    grid: np.ndarray               # final lattice (H, W)
    observables: Dict[str, np.ndarray] = field(default_factory=dict)
    mcs_completed: int = 0
    stasis_mcs: int = -1           # -1 if never reached stasis
    kept_fraction: float = 1.0     # applied / attempted proposals

    @property
    def densities(self) -> np.ndarray:
        return self.observables["densities"]

    def to_json(self) -> str:
        return json.dumps({
            "grid": np.asarray(self.grid).tolist(),
            "grid_dtype": str(np.asarray(self.grid).dtype),
            "observables": encode_observables(self.observables),
            "mcs_completed": int(self.mcs_completed),
            "stasis_mcs": int(self.stasis_mcs),
            "kept_fraction": float(self.kept_fraction),
        })

    @staticmethod
    def from_json(s: str) -> "SimResult":
        d = json.loads(s)
        return SimResult(
            grid=np.asarray(d["grid"], dtype=np.dtype(d["grid_dtype"])),
            observables=decode_observables(d["observables"]),
            mcs_completed=d["mcs_completed"],
            stasis_mcs=d["stasis_mcs"],
            kept_fraction=d["kept_fraction"])


def _kept_total(parts):
    """The applied proposals of a chunk's MCS, summed on the device."""
    return torch.stack(parts).sum(dtype=torch.int64) if parts else 0


def build_mcs_fn(params: EscgParams, dom=None,
                 device: Optional[Devices] = None):
    """``one_mcs(grid, key) -> (grid, kept, attempts)``: one MCS keyed by
    ``key`` (one ``k1`` of the MCS loop's chain ``key, k1 = split(key)``),
    on the engine the registry builds for ``params``, as the reference's.
    ``grid`` is in the engine's own form (``BuiltEngine.place``). Prefer
    ``engines.build``: its ``schedule`` derives a whole chunk's inputs at
    once."""
    built = engines.build(params, dom, device)

    def one_mcs(grid, key):
        words = torch.zeros(2, dtype=torch.int64)
        shift = torch.zeros_like(words)
        words[:], shift[:] = built.round_inputs(key)
        grid, kept = built.one_mcs(grid, words.tolist(), shift.tolist())
        return grid, kept, built.attempts_per_mcs

    return one_mcs


def build_chunk_fn(params: EscgParams, built: engines.BuiltEngine):
    """``chunk(grid, key, n_mcs) -> (grid, key, counts (n, S+1), kept,
    attempts)``, counts on the device.

    The key chain of the chunk is one host computation; with ``k_mcs > 1``
    its seeds and shifts go to the device in one copy, and the chunk runs
    ``n_mcs // k_mcs`` megakernel launches plus one remainder launch. The
    applied proposals ``kept`` are each MCS's count summed on the device,
    so the host reads them once per chunk; the megakernel drops none, so
    with ``k_mcs > 1`` they are the attempts."""
    s = params.species
    k_group = params.k_mcs

    def chunk(grid, key, n_mcs: int):
        key, seeds, shifts = built.schedule(key, n_mcs)
        attempts = n_mcs * built.attempts_per_mcs
        parts = []
        if k_group > 1:
            sched = torch.stack([seeds, shifts]).to(built.device)
            q, r = divmod(n_mcs, k_group)
            groups = [k_group] * q + ([r] if r else [])
            start = 0
            for size in groups:
                stop = start + size
                grid, cnts = built.multi_mcs(grid, sched[0, start:stop],
                                             sched[1, start:stop])
                parts.append(cnts)
                start = stop
            kept = attempts              # the megakernel drops nothing
        else:
            kept_parts = []
            for seed, shift in zip(seeds.tolist(), shifts.tolist()):
                grid, kept_mcs = built.one_mcs(grid, seed, shift)
                kept_parts.append(kept_mcs)
                parts.append(built.counts(grid, s)[None])
            kept = _kept_total(kept_parts)
        cnts = (torch.cat(parts) if parts else
                torch.zeros((0, s + 1), dtype=torch.int32,
                            device=built.device))
        return grid, key, cnts, kept, attempts

    return chunk


def build_obs_chunk_fn(params: EscgParams, built: engines.BuiltEngine):
    """Observable-pipeline chunk: ``chunk(grid, key, ring, pos, n_mcs) ->
    (grid, key, ring, pos, kept, attempts)``; returns ``(chunk,
    pipeline)``.

    The per-MCS counts never leave the device on their own: every row,
    the ``densities`` raw-count columns included, is pushed into the ring,
    and the host takes the counts from the flushed rows. The key chain and
    the device-side ``kept`` are those of :func:`build_chunk_fn`
    (observing draws nothing), so trajectories are bit-identical with
    observables on and off.

    With ``k_mcs > 1`` the lattices inside a megakernel launch never leave
    it: count-derived slices keep per-MCS cadence from the banked (K, S+1)
    counts, grid-derived slices are lag-held at their value at the start
    of the launch group."""
    pipe = obs_mod.build_pipeline(params)
    s = params.species
    k_group = params.k_mcs

    def chunk(grid, key, ring, pos, n_mcs: int):
        key, seeds, shifts = built.schedule(key, n_mcs)
        attempts = n_mcs * built.attempts_per_mcs
        if k_group > 1:
            sched = torch.stack([seeds, shifts]).to(built.device)
            q, r = divmod(n_mcs, k_group)
            start = 0
            for size in [k_group] * q + ([r] if r else []):
                stop = start + size
                held = pipe.grid_values(grid)
                grid, cnts = built.multi_mcs(grid, sched[0, start:stop],
                                             sched[1, start:stop])
                ring, pos = obs_mod.ring_push_many(
                    ring, pos, pipe.row_held(cnts, held))
                start = stop
            kept = attempts              # the megakernel drops nothing
        else:
            kept_parts = []
            for seed, shift in zip(seeds.tolist(), shifts.tolist()):
                grid, kept_mcs = built.one_mcs(grid, seed, shift)
                kept_parts.append(kept_mcs)
                row = pipe.row(grid, built.counts(grid, s))
                ring, pos = obs_mod.ring_push(ring, pos, row)
            kept = _kept_total(kept_parts)
        return grid, key, ring, pos, kept, attempts

    return chunk, pipe


def simulate(params, dom: Optional[np.ndarray] = None,
             grid0=None, key: Optional[torch.Tensor] = None,
             hooks: Sequence[Callable[[int, torch.Tensor, np.ndarray],
                                      None]] = (),
             stop_on_stasis: bool = True, *, engine=None, run=None,
             device: Optional[Devices] = None) -> SimResult:
    """Run the full simulation (paper Algorithm 3.3 control flow) on
    ``device`` (default: the card; ``device='cpu'`` runs the plain path).
    The ``sharded`` engine takes a sequence of devices for its mesh, in
    raster order (``device=["cpu"] * 4``, ``["cuda:0"] * 4``), and
    ``None`` means every visible card; it builds the lattice on the
    mesh's first device and splits it into blocks over the mesh.

    ``simulate(scenario, engine=EngineConfig(...), run=RunConfig(...))``;
    an ``EscgParams`` in the first slot carries all three layers. ``key``
    is a threefry key (``threefry.PRNGKey(seed)`` by default); without
    ``grid0`` the lattice is drawn from ``split(key)`` first, as in the
    reference.

    Chunked stasis semantics (paper §3.2.2): ``stasis_mcs`` is exact to
    the MCS, but the run only stops at the next chunk boundary. Hooks get
    ``(mcs_done, grid, counts)`` once per chunk.

    A scenario's declared observables stream unless ``run.observables``
    pins the set: the rows go to a device ring that is copied to the host
    once per chunk and must hold a full chunk (``obs_capacity`` >= the
    chunk, or 0 to size it to one). ``observables['densities']`` keeps the
    initial row; the other streams have one row per MCS run.
    """
    p, dom = resolve_config(params, dom, engine, run)
    p = p.validate()
    if dom is None:
        dom = dom_mod.circulant(p.species)
    eng = engines.build(p, dom, device)
    if p.observables:
        chunk_fn, pipe = build_obs_chunk_fn(p, eng)
    else:
        chunk_fn, pipe = build_chunk_fn(p, eng), None
    return run_built(p, eng, chunk_fn, pipe, grid0=grid0, key=key,
                     hooks=hooks, stop_on_stasis=stop_on_stasis)


def run_built(p: EscgParams, eng: engines.BuiltEngine, chunk_fn,
              pipe: Optional[obs_mod.ObsPipeline] = None, grid0=None,
              key: Optional[torch.Tensor] = None,
              hooks: Sequence[Callable[[int, torch.Tensor, np.ndarray],
                                       None]] = (),
              stop_on_stasis: bool = True,
              on_chunk: Optional[Callable[[int, int], None]] = None
              ) -> SimResult:
    """:func:`simulate`'s loop over an engine that is already built:
    ``chunk_fn`` is ``build_chunk_fn(p, eng)``, or with ``pipe`` the
    chunk of ``build_obs_chunk_fn``. ``p`` may differ from the params the
    engine and chunk were built with in what they do not bind (seed, MCS
    budget), so a server reuses one build across requests.
    ``on_chunk(mcs_done, stasis_mcs)`` is called after each chunk's
    stasis check, without the lattice."""
    dev = eng.device
    if key is None:
        key = threefry.PRNGKey(p.seed)
    cell_dt = getattr(torch, p.cell_dtype)
    if grid0 is None:
        key, k0 = threefry.split(key)
        grid0 = lattice.init_grid(k0, p.height, p.length, p.species,
                                  p.empty, dtype=cell_dt, device=dev)
    grid = eng.place(torch.as_tensor(grid0).to(device=dev, dtype=cell_dt)
                     .contiguous())
    obs_on = pipe is not None
    rows_all = []
    if obs_on:
        max_chunk = max(1, min(p.chunk_mcs, p.mcs))
        cap = obs_mod.ring_capacity(p, max_chunk)
        if cap < max_chunk:
            raise ValueError(
                f"obs_capacity {cap} < chunk rows {max_chunk}: simulate "
                "copies the ring once per chunk and its stasis accounting "
                "reads every row, so the ring must hold a full chunk "
                "(0 = auto-size)")
        ring, pos = obs_mod.ring_init(cap, (pipe.width,), dev)
    hist = [eng.counts(grid, p.species).cpu().numpy()[None]]
    mcs_done, stasis_mcs = 0, -1
    kept_total, att_total = 0, 0

    while mcs_done < p.mcs:
        n_mcs = min(p.chunk_mcs, p.mcs - mcs_done)
        if obs_on:
            grid, key, ring, pos, kept, att = chunk_fn(grid, key, ring, pos,
                                                       n_mcs)
            # one copy per chunk: the rows carry every per-MCS statistic
            rows_h = obs_mod.ring_flush(ring.cpu().numpy(), mcs_done,
                                        mcs_done + n_mcs)
            rows_all.append(rows_h)
            cnts_h = pipe.counts_from_rows(rows_h, p.species)
        else:
            grid, key, cnts, kept, att = chunk_fn(grid, key, n_mcs)
            cnts_h = cnts.cpu().numpy()          # one transfer per chunk
        hist.append(cnts_h)
        kept_total += int(kept)          # the device is done: no wait
        att_total += att
        mcs_done += n_mcs
        alive = (cnts_h[:, 1:] > 0).sum(axis=1)
        if stop_on_stasis and stasis_mcs < 0 and np.any(alive <= 1):
            stasis_mcs = mcs_done - n_mcs + int(np.argmax(alive <= 1)) + 1
        if hooks:
            whole = eng.gather(grid)
            for hook in hooks:
                hook(mcs_done, whole, cnts_h)
        if on_chunk is not None:
            on_chunk(mcs_done, stasis_mcs)
        if stop_on_stasis and stasis_mcs >= 0:
            break

    densities = np.concatenate(hist, axis=0) / p.n_cells
    observables = {"densities": densities}
    if rows_all:
        observables = pipe.split(np.concatenate(rows_all, axis=0))
        observables["densities"] = densities   # with the initial row
    return SimResult(grid=eng.gather(grid).cpu().numpy(),
                     observables=observables,
                     mcs_completed=mcs_done, stasis_mcs=stasis_mcs,
                     kept_fraction=(kept_total / att_total)
                     if att_total else 1.0)


def run_trials(params: EscgParams, dom: Optional[np.ndarray], n_trials: int,
               key: Optional[torch.Tensor] = None,
               n_mcs: Optional[int] = None,
               device: Optional[Devices] = None) -> np.ndarray:
    """The older trial runner's form over ``trials.run_trials``: the final
    survival mask only, (n_trials, S) bool, without the stasis exit.
    Prefer ``trials.run_trials``, which returns the whole
    ``TrialResult``."""
    from .trials import run_trials as _run_trials  # trials imports this
    return _run_trials(params, dom, n_trials, key=key, n_mcs=n_mcs,
                       stop_on_stasis=False, device=device).survival
