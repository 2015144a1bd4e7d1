"""The batched engine's semantics (E2, Algorithms 3.5/3.6), frozen for the
benchmark: no torus shift, and one MCS of every lane.

n_sub windows (the first of 8, 4, 2 that divides N, else 1) of N / n_sub
proposals, each drawn from ``split(window key, 4)`` (cell, direction, two
uniforms) over the whole torus, the window keys ``split(k1, n_sub)``; in a
window the first proposal to touch a cell owns it, a proposal that owns
both its cells applies the rule to the window's starting lattice, the
others are dropped.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import threefry as tf
from .escg import DIRS, Model, rule


def shift(k1, tile: Tuple[int, int]) -> Tuple[int, int]:
    return (0, 0)


def windows(n_cells: int) -> int:
    for d in (8, 4, 2):
        if n_cells % d == 0:
            return d
    return 1


def mcs(grids: torch.Tensor, steps, m: Model,
        precision: str = "float32") -> torch.Tensor:
    """One MCS for each lane: ``steps`` a list of (words, shift), one per
    lane (the shift unused)."""
    lanes, h, w = grids.shape
    n = h * w
    n_sub = windows(n)
    b = n // n_sub
    dev = grids.device
    k1 = torch.tensor([list(words) for words, _ in steps], dtype=torch.int64,
                      device=dev)
    keys = tf.split(k1, n_sub)                       # (L, n_sub, 2)
    dirs = torch.tensor(DIRS, dtype=torch.int64, device=dev)
    flat = grids.reshape(lanes, n).clone()
    order = torch.arange(b, dtype=torch.int64, device=dev).expand(lanes, b)
    base = (torch.arange(lanes, device=dev) * (n + 1))[:, None]
    for j in range(n_sub):
        sub = tf.split(keys[:, j], 4)                # (L, 4, 2)
        cell = tf.randint(sub[:, 0], b, 0, n)
        d = dirs[tf.randint(sub[:, 1], b, 0, m.neighbourhood)]
        u_act, u_dom = tf.uniform(sub[:, 2], b), tf.uniform(sub[:, 3], b)
        r = (cell // w + d[..., 0]) % h
        c = (cell % w + d[..., 1]) % w
        nb = r * w + c
        owner = torch.full((lanes, n), b, dtype=torch.int64, device=dev)
        owner.scatter_reduce_(1, cell, order, "amin")
        owner.scatter_reduce_(1, nb, order, "amin")
        keep = (owner.gather(1, cell) == order) & (owner.gather(1, nb)
                                                   == order)
        s, t = rule(flat.gather(1, cell), flat.gather(1, nb), u_act, u_dom,
                    m, precision)
        # dropped proposals write into a spare cell past each lane's end
        padded = torch.cat([flat, flat.new_zeros(lanes, 1)], 1).reshape(-1)
        spare = n
        padded[(base + torch.where(keep, cell, spare)).reshape(-1)] = \
            torch.where(keep, s, 0).reshape(-1)
        padded[(base + torch.where(keep, nb, spare)).reshape(-1)] = \
            torch.where(keep, t, 0).reshape(-1)
        flat = padded.reshape(lanes, n + 1)[:, :n]
    return flat.reshape(lanes, h, w)
