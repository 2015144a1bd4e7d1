"""Dominance-network builders (paper §3.1.1, §4.3).

A copy of ``repro.core.dominance`` (numpy only): the port imports nothing
of the reference package.

A dominance network over S species is stored as an (S+1, S+1) float32 matrix
``D`` where ``D[i, j]`` is the probability that species ``i`` kills species
``j`` on an interaction event. Row/column 0 belong to the *empty* site and are
always zero — this removes every emptiness branch from the inner update rule
(the kernels index ``D`` directly with raw cell values).

Deterministic networks (the classic ESCGs) use probabilities in {0, 1};
probabilistic networks (Park, Chen & Szolnoki 2023) use rates in [0, 1].
"""
from __future__ import annotations

import csv
import io
from typing import Iterable, Sequence, Tuple

import numpy as np

__all__ = [
    "circulant", "ablate", "from_dense", "to_csv", "from_csv",
    "park_alliance_network", "RPS", "RPSLS", "zhong_ablated_rpsls",
]


def from_dense(mat: np.ndarray) -> np.ndarray:
    """Embed an (S, S) species-only matrix into the (S+1, S+1) padded form."""
    mat = np.asarray(mat, dtype=np.float32)
    s = mat.shape[0]
    if mat.shape != (s, s):
        raise ValueError("dominance matrix must be square")
    out = np.zeros((s + 1, s + 1), dtype=np.float32)
    out[1:, 1:] = mat
    return out


def circulant(species: int, offsets: Sequence[int] = (1,),
              rate: float = 1.0) -> np.ndarray:
    """Circulant dominance graph C(S, K) (paper eq. in §3.1.1).

    ``D[i][j] = rate`` iff ``(j - i + S) mod S in K`` (0-indexed species).
    RPS = C(3, {1});  RPSLS = C(5, {1, 2}).
    """
    if species < 1:
        raise ValueError("species >= 1")
    ks = set(int(k) % species for k in offsets)
    if 0 in ks:
        raise ValueError("offset 0 (self-dominance) not allowed")
    m = np.zeros((species, species), dtype=np.float32)
    for i in range(species):
        for k in ks:
            m[i, (i + k) % species] = rate
    return from_dense(m)


def ablate(dom: np.ndarray, edges: Iterable[Tuple[int, int]]) -> np.ndarray:
    """Remove directed edges (winner, loser), 1-indexed species ids."""
    out = np.array(dom, copy=True)
    for w, l in edges:
        if not (1 <= w < out.shape[0] and 1 <= l < out.shape[0]):
            raise ValueError(f"edge ({w},{l}) out of range")
        out[w, l] = 0.0
    return out


# ----------------------------- named presets ----------------------------- #

def RPS() -> np.ndarray:
    return circulant(3, (1,))


# The canonical embedding of real RPSLS into the circulant C(5, {1, 2})
# ("species i beats i+1 and i+2") orders the species as:
ROCK, SCISSORS, LIZARD, PAPER, SPOCK = 1, 2, 3, 4, 5
# check: Rock>Scissors,Lizard; Scissors>Lizard,Paper; Lizard>Paper,Spock;
#        Paper>Spock,Rock; Spock>Rock,Scissors  — all ten real RPSLS edges.


def RPSLS() -> np.ndarray:
    """Rock-Paper-Scissors-Lizard-Spock = C(5, {1, 2}) (paper Fig 3.1)."""
    return circulant(5, (1, 2))


def zhong_ablated_rpsls() -> np.ndarray:
    """Zhong et al. (2022) Fig 2: RPSLS with the Rock-crushes-Scissors edge
    removed (paper §3.1.2). In C(5,{1,2}) ordering that edge is
    (ROCK, SCISSORS) = (1, 2); the species observed to go extinct within
    200-600 MCS is PAPER (= id 4 here).
    """
    return ablate(RPSLS(), [(ROCK, SCISSORS)])


def park_alliance_network(alpha: float, beta: float,
                          gamma: float = 1.0) -> np.ndarray:
    """Eight-species network of Park, Chen & Szolnoki (2023) (paper Fig 4.8).

    Construction (documented reconstruction — the dissertation itself reports
    Park et al.'s description as ambiguous, §4.3.2):
      * gamma: Lotka-Volterra ring, species i beats i+1 (mod 8);
      * alpha: intra-alliance 4-cycles, species i beats i+2 (mod 8), which
        splits the ring into alliances A = {1,3,5,7} and B = {2,4,6,8};
      * beta : symmetry-breaking extra edges in ONE alliance only —
        diagonals of alliance A: i -> i+4 for i in {1, 3, 5, 7}.
    All edges are probabilistic interaction rates.
    """
    s = 8
    m = np.zeros((s, s), dtype=np.float32)
    for i in range(s):                      # 0-indexed internally
        m[i, (i + 1) % s] = gamma
        m[i, (i + 2) % s] = alpha
    for i in (0, 2, 4, 6):                  # alliance A = species 1,3,5,7
        m[i, (i + 4) % s] = max(m[i, (i + 4) % s], beta)
    return from_dense(m)


# --------------------------------- csv ----------------------------------- #

def to_csv(dom: np.ndarray) -> str:
    """Serialize the species-only (S, S) block as CSV (paper dominance.csv)."""
    buf = io.StringIO()
    w = csv.writer(buf)
    for row in np.asarray(dom)[1:, 1:]:
        w.writerow([f"{v:g}" for v in row])
    return buf.getvalue()


def from_csv(text: str) -> np.ndarray:
    rows = [r for r in csv.reader(io.StringIO(text)) if r]
    mat = np.array([[float(v) for v in r] for r in rows], dtype=np.float32)
    return from_dense(mat)


def n_species(dom: np.ndarray) -> int:
    return int(dom.shape[0]) - 1
