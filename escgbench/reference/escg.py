"""The plain reference of the ESCG step, frozen for the benchmark: what a
trial study computes, written from the semantics of the JAX package that
the port reproduces, in plain PyTorch on any device. It imports nothing
of the program and takes nothing the program made: the model comes from
the configuration file, the keys from the seed.

A *lane* is one trial at one stage of a run; lanes run side by side as
one (L, H, W) tensor of labels (0 empty, 1..S species).

* Trial keys: trial t of run key K is ``fold_in(K, t)``, split into the
  lattice key kg and the chain key kr.
* Lattice: ``split(kg)`` gives k1, k2; a cell is empty where the uniform
  of k1 falls below the empty share, else the species ``randint(k2, 1,
  S + 1)``.
* Chain: before each MCS ``key, k1 = split(key)``; the engine's module
  (``reference/<engine>.py``) draws the MCS's torus shift from k1 and
  runs one MCS of every lane (``shift``, ``mcs``).
* Rule (Algorithm 3.2) on a pair (s, n) with s != n: u_act below t_eps
  swaps; below t_eps_mu interacts (u_dom below D[s, n] empties n, else
  below D[s, n] + D[n, s] empties s); else reproduces into an empty cell.
  The thresholds are float32 roundings of eps / (eps + mu + sigma) and
  (eps + mu) / (...), eps = 2 M N.
* Rows: per MCS the label counts and, where declared, the unlike
  nearest-neighbour bonds of the torus (right and down). With ``k_mcs``
  > 1 MCS a launch, the bonds of a launch's MCS are those of the lattice
  the launch started from (held, as the program's megakernel path does).

``precision`` = "bfloat16" runs the rule's comparisons in bfloat16: the
control that the correctness check has to fail.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from . import threefry as tf

MASK = tf.MASK
DIRS = ((-1, 0), (1, 0), (0, -1), (0, 1), (-1, -1), (-1, 1), (1, -1),
        (1, 1))


@dataclass(frozen=True)
class Model:
    """One configuration file's model, as the reference reads it."""
    height: int
    width: int
    species: int
    dom: np.ndarray            # (S + 1, S + 1) float32, row/col 0 empty
    t_eps: float
    t_eps_mu: float
    neighbourhood: int
    empty: float
    tile: Tuple[int, int]
    observables: Tuple[str, ...]

    @property
    def n_cells(self) -> int:
        return self.height * self.width

    @staticmethod
    def from_config(cfg: dict) -> "Model":
        s = int(cfg["species"])
        dom = np.zeros((s + 1, s + 1), np.float32)
        dom[1:, 1:] = np.asarray(cfg["dominance"], np.float32)
        n = int(cfg["length"]) * int(cfg["height"])
        eps = 2.0 * float(cfg["mobility"]) * n
        total = eps + float(cfg["mu"]) + float(cfg["sigma"])
        return Model(height=int(cfg["height"]), width=int(cfg["length"]),
                     species=s, dom=dom, t_eps=eps / total,
                     t_eps_mu=(eps + float(cfg["mu"])) / total,
                     neighbourhood=int(cfg["neighbourhood"]),
                     empty=float(cfg["empty"]),
                     tile=tuple(int(v) for v in cfg["tile"]),
                     observables=tuple(cfg["observables"]))


# ------------------------------- keys -------------------------------------- #

def trial_keys(run_key: Tuple[int, int], trial: int):
    """(kg, kr) of one trial."""
    return tf.split_words(tf.fold_in_words(run_key, trial))


def engine_module(engine: str):
    """``reference/<engine>.py``: the engine's ``shift`` and ``mcs``."""
    return importlib.import_module(f".{engine}", __package__)


def chain(key, n_mcs: int, engine: str, tile: Tuple[int, int]):
    """Walk ``n_mcs`` MCS of the chain from ``key``; returns (key after,
    [(words, shift)] per MCS)."""
    shift = engine_module(engine).shift
    out = []
    for _ in range(n_mcs):
        key, k1 = tf.split_words(key)
        out.append((k1, shift(k1, tile)))
    return key, out


def lattice(kg, m: Model, device) -> torch.Tensor:
    """(H, W) int64 labels of one trial's starting lattice."""
    k1, k2 = tf.split_words(kg)
    keys = torch.tensor([k1, k2], dtype=torch.int64, device=device)
    n = m.n_cells
    occupied = tf.uniform(keys[0], n) >= torch.tensor(
        m.empty, dtype=torch.float32, device=device)
    labels = tf.randint(keys[1], n, 1, m.species + 1)
    return torch.where(occupied, labels, 0).reshape(m.height, m.width)


# -------------------------------- rule -------------------------------------- #

def rule(s, n, u_act, u_dom, m: Model, precision: str):
    dt = torch.bfloat16 if precision == "bfloat16" else torch.float32
    dev = s.device
    dom = torch.as_tensor(m.dom, device=dev).to(dt)
    u_act, u_dom = u_act.to(dt), u_dom.to(dt)
    te = torch.tensor(m.t_eps, dtype=torch.float32, device=dev).to(dt)
    tem = torch.tensor(m.t_eps_mu, dtype=torch.float32, device=dev).to(dt)
    migrate = u_act < te
    interact = ~migrate & (u_act < tem)
    reproduce = ~migrate & ~interact
    p1, p2 = dom[s, n], dom[n, s]
    kill_n = interact & (u_dom < p1)
    kill_s = interact & ~kill_n & (u_dom < p1 + p2)
    zero = torch.zeros_like(s)
    new_s = torch.where(migrate, n, torch.where(
        kill_s, zero, torch.where(reproduce & (s == 0), n, s)))
    new_n = torch.where(migrate, s, torch.where(
        kill_n, zero, torch.where(reproduce & (n == 0), s, n)))
    same = s == n
    return torch.where(same, s, new_s), torch.where(same, n, new_n)


# --------------------------------- rows ------------------------------------- #

def row(grids: torch.Tensor, m: Model) -> np.ndarray:
    """(L, width) int64 raw row of each lane: the label counts 0..S, then
    the unlike bonds where ``interface_length`` is declared."""
    lanes = grids.shape[0]
    s1 = m.species + 1
    flat = grids.reshape(lanes, -1)
    off = (torch.arange(lanes, device=grids.device) * s1)[:, None]
    counts = torch.bincount((flat + off).reshape(-1),
                            minlength=lanes * s1).reshape(lanes, s1)
    parts = [counts]
    if "interface_length" in m.observables:
        unlike = ((grids != torch.roll(grids, -1, 2)).sum(dim=(1, 2))
                  + (grids != torch.roll(grids, -1, 1)).sum(dim=(1, 2)))
        parts.append(unlike[:, None])
    return torch.cat(parts, 1).cpu().numpy()


def as_ring(raw: np.ndarray) -> np.ndarray:
    """Raw rows as the program's device ring holds them: each integer
    rounded to float32."""
    return raw.astype(np.float32)


def run(grids: torch.Tensor, plan, m: Model, engine: str,
        precision: str = "float32", k_mcs: int = 1):
    """Advance the lanes through ``plan`` (per lane, a list of (words,
    shift) of equal length: one chunk, its launches of ``k_mcs`` MCS
    counted from its start); returns (lanes after, raw rows (L, MCS,
    width))."""
    step = engine_module(engine).mcs
    counts = m.species + 1
    rows, held = [], None
    for i in range(len(plan[0])):
        if k_mcs > 1 and i % k_mcs == 0:
            held = row(grids, m)[:, counts:]
        grids = step(grids, [p[i] for p in plan], m, precision)
        r = row(grids, m)
        if held is not None:
            r[:, counts:] = held
        rows.append(r)
    return grids, np.stack(rows, 1)
