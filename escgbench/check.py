"""Whether what the window's study produced is right: the program's
outputs held to the plain reference (``reference/``), once the window has
closed, the peak memory has been read and the program's state is freed.

A run samples, from its seed, one trial from each of (up to) four equal
blocks of the batch and two of those again, and one chunk c inside the
first half of the window (a fraction drawn from the seed, set when the
window opens and the chunk's time is known). What is compared, each a
count of entries that differ:

* ``start_cells_off``: the sampled trials' lattices before the first MCS
  and after the first chunk, against the reference run from the seed
  (trial keys, lattice, key chain, draws, update);
* ``start_rows_off``: their per-MCS rows of the first chunk (the label
  counts, and the unlike bonds where ``interface_length`` is declared)
  as they reached the host from the device ring, in float32;
* ``late_cells_off``, ``late_rows_off``: chunk c of two of them, the
  reference started from the program's own lattice before chunk c (the
  key chain walked from the seed): the reference cannot follow thousands
  of MCS of the window within a run, so the late stage is checked from
  the program's state and the start is checked by itself.

Every comparison is exact, as the program's trajectories are bit for bit
the reference's; the limits are in ``checks.json``.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

from .reference import escg

HERE = Path(__file__).resolve().parent
NAMES = ("start_cells_off", "start_rows_off", "late_cells_off",
         "late_rows_off")


def limits() -> Dict[str, float]:
    with open(HERE / "checks.json") as f:
        return {k: float(v["limit"]) for k, v in json.load(f).items()}


@dataclass(frozen=True)
class Sample:
    start: Tuple[int, ...]      # trials checked from the seed
    late: Tuple[int, ...]       # trials checked at chunk c
    fraction: float             # where chunk c lies in the window's half

    def chunk_c(self, lead: int, chunks_in_half: float) -> int:
        """Chunk c (1-based): at least ``lead`` + 2, so that it starts
        after the window has opened and has not been dispatched yet."""
        return lead + 2 + int(self.fraction * max(
            0.0, chunks_in_half - lead - 2))


def draw(seed: int, trials: int) -> Sample:
    """The sample of a run: a trial from each of up to four blocks, two of
    them again, and the fraction that places chunk c."""
    rng = np.random.default_rng([seed % 2 ** 63, 0x5EED])
    blocks = min(4, trials)
    edges = np.linspace(0, trials, blocks + 1).astype(int)
    start = tuple(int(rng.integers(a, b)) for a, b in zip(edges[:-1],
                                                          edges[1:]))
    late = tuple(sorted(int(t) for t in rng.choice(
        start, size=min(2, len(start)), replace=False)))
    return Sample(start, late, float(rng.random()))


def start_points(sample: Sample, chunk: int) -> Dict[int, List[int]]:
    return {0: list(sample.start), chunk: list(sample.start)}


class ProgramOutputs:
    """The study's outputs: the captured lattices and the rows of every
    chunk as they reached the host."""

    def __init__(self, capture, flushed: List[np.ndarray]):
        self.capture = capture
        self.rows_all = np.concatenate(flushed, axis=0)   # (T, n, width)

    def cells(self, m: int, t: int) -> torch.Tensor:
        return self.capture.buffers[(m, t)]

    def rows(self, t: int, lo: int, hi: int) -> np.ndarray:
        return self.rows_all[lo:hi, t]


class ReferenceOutputs:
    """The reference put in the program's place (the control): the sampled
    trials run from the seed through chunk c at ``precision``."""

    def __init__(self, model, engine, key, sample, chunk, chunk_c, device,
                 precision, k_mcs=1):
        trials = sorted(set(sample.start) | set(sample.late))
        self.at = {t: i for i, t in enumerate(trials)}
        keep = {1, chunk_c - 1, chunk_c}
        grids, plans = [], []
        for t in trials:
            kg, kr = escg.trial_keys(key, t)
            grids.append(escg.lattice(kg, model, device))
            plans.append(escg.chain(kr, chunk_c * chunk, engine,
                                    model.tile)[1])
        g = torch.stack(grids)
        self.saved = {0: g.cpu()}
        raws = []
        for i in range(chunk_c):
            lo = i * chunk
            g, raw = escg.run(g, [p[lo:lo + chunk] for p in plans], model,
                              engine, precision, k_mcs)
            raws.append(raw)
            if i + 1 in keep:
                self.saved[lo + chunk] = g.cpu()
        self.raw = np.concatenate(raws, 1)

    def cells(self, m: int, t: int) -> torch.Tensor:
        return self.saved[m][self.at[t]]

    def rows(self, t: int, lo: int, hi: int) -> np.ndarray:
        return escg.as_ring(self.raw[self.at[t], lo:hi])


def _off(a, b) -> int:
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return int(max(a.size, b.size))
    return int(np.sum(a != b))


def _cells_off(ref: torch.Tensor, prog: torch.Tensor) -> int:
    return int((ref.cpu() != prog.cpu().to(ref.dtype)).sum())


def compare(model: escg.Model, engine: str, key, sample: Sample, chunk: int,
            c: int, outputs, device, k_mcs: int = 1
            ) -> Tuple[Dict[str, int], int]:
    """The four numbers of ``NAMES`` for ``outputs`` against the
    reference run at float32 on ``device`` (``k_mcs`` MCS a launch), chunk
    ``c`` the late one, and how many sampled (trial, chunk) answers
    differ."""
    grids, plans, lanes = [], [], []
    for t in sample.start:
        kg, kr = escg.trial_keys(key, t)
        grids.append(escg.lattice(kg, model, device))
        plans.append(escg.chain(kr, chunk, engine, model.tile)[1])
        lanes.append(("start", t))
    start0 = [g.clone() for g in grids]
    for t in sample.late:
        _, kr = escg.trial_keys(key, t)
        walked, _ = escg.chain(kr, (c - 1) * chunk, engine, model.tile)
        plans.append(escg.chain(walked, chunk, engine, model.tile)[1])
        grids.append(outputs.cells((c - 1) * chunk, t).to(
            device=device, dtype=torch.int64))
        lanes.append(("late", t))
    after, raw = escg.run(torch.stack(grids), plans, model, engine,
                          k_mcs=k_mcs)
    out = dict.fromkeys(NAMES, 0)
    bad = 0
    for i, (stage, t) in enumerate(lanes):
        if stage == "start":
            cells = (_cells_off(start0[i], outputs.cells(0, t))
                     + _cells_off(after[i], outputs.cells(chunk, t)))
            lo = 0
        else:
            cells = _cells_off(after[i], outputs.cells(c * chunk, t))
            lo = (c - 1) * chunk
        rows = _off(escg.as_ring(raw[i]), outputs.rows(t, lo, lo + chunk))
        out[f"{stage}_cells_off"] += cells
        out[f"{stage}_rows_off"] += rows
        bad += cells + rows > 0
    return out, bad
