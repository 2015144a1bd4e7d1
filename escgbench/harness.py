"""One run of one cell: the files a cell is made of, the program's set-up,
the measured window of ``run_trials`` and what it leaves to check and
read.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``: its
configuration file (``configs/``), its traffic file (``traffic/<traffic>
.json``: engine, trials, MCS a chunk), the engine's work file (``work/``)
and the metrics that name it, each a reader in ``metrics/<name>.py``.

The window is one call of ``repro_torch.core.trials.run_trials``, the
study's entry, with ``stop_on_stasis`` off and more MCS than any window
holds. Its first ``LEAD`` chunks are set-up: they warm every shape the
window uses. The window opens at the hook after them and closes at the
first hook at least ``seconds`` later, which ends the study by raising
``WindowClosed``.

What the check reads is taken where the program produces it, by the
benchmark's own wrappers, which change no argument and no result: while
the study runs, ``trials.build_trial_chunk`` is wrapped so that the
lattices of the sampled trials are copied, asynchronously into pinned
host memory, where the chunks the check replays start (every point it
compares lies on a chunk's edge, whatever ``k_mcs`` is), and
``observables.ring_flush`` so that every chunk's rows are kept as they
reach the host. In a traced run the layers also run inside the
benchmark's ``record_function`` ranges (``watched_study``), which the
traced window reads (``trace.py``).
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .reference.escg import Model

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "escgbench"
# chunks of the study before the window opens: the first warms every
# shape, the second lets the caching allocator settle with one chunk in
# flight
LEAD = 2
# MCS asked of the study: more than any window holds
ENDLESS = 1 << 40


def process_age() -> float:
    """Seconds since this process started (10 ms resolution), 0 where
    /proc does not say."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


# ------------------------------- the files --------------------------------- #

def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    work: dict
    peaks: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def model(self) -> Model:
        return Model.from_config(self.config)

    @property
    def engine(self) -> str:
        return self.traffic["engine"]

    @property
    def trials(self) -> int:
        return int(self.traffic["trials"])

    @property
    def chunk(self) -> int:
        return int(self.traffic["chunk_mcs"])

    @property
    def k_mcs(self) -> int:
        return int(self.traffic.get("k_mcs", 1))


def load_cell(name: str, root: Path = ROOT,
              overrides: Optional[dict] = None) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files;
    ``overrides`` ({"config": {...}, "traffic": {...}}) shrink it for the
    CPU tests."""
    spec = _json(root / "BENCHMARK.json")
    by_name = {w["name"]: w for w in spec["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(by_name)}")
    wl = by_name[name]
    conf = {c["name"]: c for c in spec["configs"]}[wl["config"]]
    config = _json(root / conf["file"])
    traffic = _json(root / "escgbench" / "traffic" / f"{wl['traffic']}.json")
    overrides = overrides or {}
    config.update(overrides.get("config", {}))
    traffic.update(overrides.get("traffic", {}))
    return Cell(
        name=name, chips=int(wl["chips"]), config=config, traffic=traffic,
        work=_json(root / "escgbench" / "work" / f"{traffic['engine']}.json"),
        peaks=_json(root / "escgbench" / "peaks.json"),
        end_to_end=[m for m in spec["end_to_end"] if applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if applies(m, name)])


# --------------------------------- work ------------------------------------ #

def work_per_trial_mcs(cell: Cell, parts) -> Tuple[float, float]:
    """(instructions, bytes) of ``parts`` of the work file for one
    trial-MCS; ``parts=None`` is the whole step: the update, the counts and
    the declared observables, the lattice read once and written once."""
    m = cell.model
    n = m.n_cells
    cell_bytes = torch.empty((), dtype=getattr(
        torch, cell.config["cell_dtype"])).element_size()
    if cell.work["proposals"] == "tiles":
        th, tw = m.tile
        tiles = (m.height // th) * (m.width // tw)
        proposals = tiles * math.ceil(n / tiles)
    else:
        proposals = n
    names = parts if parts is not None else (
        ["update", "counts"] + list(m.observables))
    instr = byts = 0.0
    for name in names:
        part = cell.work["parts"][name]
        instr += (part["instructions_per_proposal"] * proposals
                  + part["instructions_per_cell"] * n)
        byts += (part["lattice_reads"] + part["lattice_writes"]) * n \
            * cell_bytes
    if parts is None:
        step = cell.work["step"]
        byts = (step["lattice_reads"] + step["lattice_writes"]) * n \
            * cell_bytes
    return instr, byts


def least_seconds(cell: Cell, parts, trials: int) -> float:
    """The least time of ``parts`` (see ``work_per_trial_mcs``) for one
    MCS of ``trials`` trials at the card's peaks."""
    instr, byts = work_per_trial_mcs(cell, parts)
    return trials * max(instr / cell.peaks["issue_rate_per_s"],
                        byts / cell.peaks["hbm_bytes_per_s"])


# ------------------------------- the program ------------------------------- #

def run_key(seed: int) -> Tuple[int, int]:
    """The study's key from ``--seed``: its high and low 32-bit words."""
    return ((seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF)


def program_inputs(cell: Cell):
    """(scenario, EngineConfig, RunConfig) of the cell, after checking that
    the program's preset is the configuration file's model."""
    from repro_torch.core.scenarios import (EngineConfig, RunConfig,
                                            make_scenario)
    cfg = cell.config
    sc = make_scenario(cfg["scenario"])
    want = {"species": cfg["species"], "mobility": cfg["mobility"],
            "mu": cfg["mu"], "sigma": cfg["sigma"], "empty": cfg["empty"],
            "neighbourhood": cfg["neighbourhood"],
            "boundary": cfg["boundary"]}
    got = {k: getattr(sc, k) for k in want}
    dom = np.asarray(sc.dominance())[1:, 1:]
    if got != want or not np.array_equal(dom, np.asarray(cfg["dominance"])):
        raise ValueError(f"preset {cfg['scenario']!r} is {got} with "
                         f"dominance {dom.tolist()}, the file {want} with "
                         f"{cfg['dominance']}")
    eng = EngineConfig(engine=cell.engine, cell_dtype=cfg["cell_dtype"],
                       tile=tuple(cfg["tile"]),
                       k_mcs=cell.k_mcs)
    run = RunConfig(length=cfg["length"], height=cfg["height"],
                    chunk_mcs=cell.chunk)
    return sc, eng, run


@dataclass
class Capture:
    """Lattices of sampled trials copied at given MCS of the study:
    ``points`` maps an MCS index m (the lattice after m MCS) to trials;
    ``late`` trials get their points when the window fixes its chunk."""
    points: Dict[int, List[int]]
    late: Tuple[int, ...]
    shape: Tuple[int, int]
    dtype: torch.dtype
    pinned: bool
    buffers: Dict[Tuple[int, int], torch.Tensor] = field(default_factory=dict)
    spare: Dict[int, List[torch.Tensor]] = field(default_factory=dict)

    def __post_init__(self):
        for m, trials in self.points.items():
            for t in trials:
                self.buffers[(m, t)] = self._buffer()
        # two lattices per late trial, taken at points set later
        self.spare = {t: [self._buffer(), self._buffer()] for t in self.late}

    def _buffer(self) -> torch.Tensor:
        return torch.empty(self.shape, dtype=self.dtype,
                           pin_memory=self.pinned)

    def add_late(self, first: int, second: int) -> None:
        for t in self.late:
            for m, buf in zip((first, second), self.spare[t]):
                self.points.setdefault(m, []).append(t)
                self.buffers[(m, t)] = buf

    def take(self, m: int, grids: torch.Tensor) -> None:
        for t in self.points.get(m, ()):
            self.buffers[(m, t)].copy_(grids[t], non_blocking=True)


def _spanned(name: str, fn):
    """``fn`` run inside the benchmark's ``record_function`` range
    ``name``; the profiler marks the device work it launches with it."""
    from torch.profiler import record_function

    def call(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)
    return call


class _SpannedPipeline:
    """An observables pipeline whose device-side rows run inside the
    ``escgbench.observables`` range."""

    def __init__(self, pipe):
        self._pipe = pipe

    def __getattr__(self, name):
        value = getattr(self._pipe, name)
        if name in ("row", "row_held", "grid_values"):
            return _spanned("escgbench.observables", value)
        return value


@dataclass
class KeyChain:
    """The study's key chain as its first chunk called it: the built
    engine's ``schedule_batch`` and the trials' keys it was given."""
    schedule_batch: object = None
    keys: Optional[torch.Tensor] = None


@contextlib.contextmanager
def watched_study(capture: Capture, rows: list, spans: bool,
                  keychain: KeyChain):
    """While open, the program's trial chunks copy the capture's lattices
    at the MCS where a chunk starts, every flush of the observables' ring
    appends its rows, (MCS, trials, width), to ``rows``, and the first
    call of the key chain is kept in ``keychain``. With ``spans`` the
    layers run inside the benchmark's ``record_function`` ranges: the key
    chain, the update (and on ``batched`` its draws and arbitration), the
    counts and the observables' rows."""
    from repro_torch.core import batched, engines, observables, trials
    saved = [(trials, "build_trial_chunk"), (observables, "ring_flush"),
             (engines, "build")]
    if spans:
        saved += [(observables, "build_pipeline"),
                  (engines, "proposal_batch"),
                  (batched, "run_proposals_trials")]
    originals = [getattr(mod, name) for mod, name in saved]
    build_chunk, flush, build = originals[:3]

    def watched_chunk(*args, **kwargs):
        chunk = build_chunk(*args, **kwargs)
        done = [0]

        def call(grids, keys, n_mcs):
            capture.take(done[0], grids)
            done[0] += n_mcs
            return chunk(grids, keys, n_mcs)
        return call

    def watched_flush(buf, start, stop):
        out = flush(buf, start, stop)
        rows.append(out)
        return out

    def watched_build(*args, **kwargs):
        built = build(*args, **kwargs)
        schedule = built.schedule_batch

        def schedule_batch(keys, n_mcs):
            if keychain.keys is None:
                keychain.schedule_batch, keychain.keys = schedule, keys.clone()
            return schedule(keys, n_mcs)

        repl = {"schedule_batch": schedule_batch}
        if spans:
            repl = {"schedule_batch": _spanned("escgbench.keychain",
                                               schedule_batch),
                    "counts_batch": _spanned("escgbench.counts",
                                             built.counts_batch)}
            for name in ("one_mcs_batch", "multi_mcs_batch"):
                if getattr(built, name) is not None:
                    repl[name] = _spanned("escgbench.update",
                                          getattr(built, name))
        return built._replace(**repl)

    patched = [watched_chunk, watched_flush, watched_build]
    if spans:
        patched += [
            lambda p: _SpannedPipeline(originals[3](p)),
            _spanned("escgbench.draws", originals[4]),
            _spanned("escgbench.arbitration", originals[5])]
    for (mod, name), fn in zip(saved, patched):
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for (mod, name), fn in zip(saved, originals):
            setattr(mod, name, fn)


class WindowClosed(Exception):
    """Raised from the study's hook to end it once the window has closed."""


class Clock:
    """The hook of ``run_trials``: the time of every chunk's end. Opens the
    window after ``LEAD`` chunks; there ``on_open(chunk seconds)`` may set
    what the check samples; closes it at the first hook at least
    ``seconds`` later, at or after ``until`` (a chunk index) and after the
    tracer's chunks, reads the peak memory and ends the study.

    With a tracer, the window's first half runs untraced, for the wall
    (``untraced_s_per_mcs``: the profiler slows the host, and its start
    takes seconds); the tracer starts at the first hook after it and
    covers its chunks."""

    def __init__(self, seconds: float, device: torch.device, tracer=None,
                 on_open=None):
        self.seconds = seconds
        self.device = device
        self.tracer = tracer
        self.on_open = on_open
        self.until = 0
        self.times: List[float] = []
        self.mcs: List[int] = []
        self.traced_from: Optional[int] = None    # index into ``times``
        self.peak_bytes = 0

    def __call__(self, mcs_done: int, alive) -> None:
        t = time.perf_counter()
        self.times.append(t)
        self.mcs.append(int(mcs_done))
        chunks = len(self.times)             # chunks done so far
        if chunks == LEAD and self.on_open is not None:
            self.on_open(t - self.times[-2])
        elapsed = t - self.times[LEAD - 1] if chunks >= LEAD else 0.0
        tracer = self.tracer
        if tracer is not None and chunks > LEAD and not tracer.done:
            if self.traced_from is None and elapsed >= self.seconds / 2:
                self.traced_from = chunks - 1
            if self.traced_from is not None:
                tracer.hook(chunks - 1 - self.traced_from)
        if chunks > LEAD and chunks >= self.until and \
                elapsed >= self.seconds and (tracer is None or tracer.done):
            if self.device.type == "cuda":
                self.peak_bytes = int(
                    torch.cuda.max_memory_allocated(self.device))
            raise WindowClosed

    def intervals_ms(self) -> np.ndarray:
        return np.diff(np.asarray(self.times[LEAD - 1:])) * 1e3

    def untraced_s_per_mcs(self) -> Optional[float]:
        """Wall seconds an MCS from the window's opening to the tracer's
        start; None without a tracer or where that holds under two
        chunks."""
        i, j = LEAD - 1, self.traced_from
        if j is None or j - i < 2:
            return None
        return (self.times[j] - self.times[i]) / (self.mcs[j] - self.mcs[i])

    @property
    def window_s(self) -> float:
        return self.times[-1] - self.times[LEAD - 1]

    @property
    def window_mcs(self) -> int:
        return self.mcs[-1] - self.mcs[LEAD - 1]

    @property
    def window_chunks(self) -> int:
        return len(self.times) - LEAD


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def study(cell: Cell, key: Tuple[int, int], device, clock: Clock) -> None:
    """The cell's study, ``run_trials``, until ``clock`` closes the
    window."""
    from repro_torch.core.trials import run_trials
    sc, eng, run = program_inputs(cell)
    try:
        run_trials(sc, n_trials=cell.trials,
                   key=torch.tensor(key, dtype=torch.int64), n_mcs=ENDLESS,
                   chunk_mcs=cell.chunk, stop_on_stasis=False,
                   hooks=[clock], engine=eng, run=run, device=device)
    except WindowClosed:
        return
    raise RuntimeError("the study ended before its window closed")
