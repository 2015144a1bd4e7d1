"""The fused sweep's semantics (the ``pallas_fused`` engine), frozen for
the benchmark: the MCS's torus shift drawn from its chain key, and one MCS
of every lane.

* Shift: ``randint(fold_in(k1, 1), (0, 0), (th, tw))``.
* Sweep: the lattice is read rolled by minus the shift and stays in that
  frame; each (th, tw) tile, in raster order t, applies K = ceil(N /
  tiles) proposals in order, proposal j from Philox counter (t K + j, 0,
  0, 0) keyed by k1's words: cell = w0 mod the interior ((th-2) x (tw-2),
  inset 1), direction w1 mod the neighbourhood, the two uniforms (w >> 8)
  2^-24.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from . import threefry as tf
from .escg import DIRS, MASK, Model, rule
from .philox import philox


def shift(k1, tile: Tuple[int, int]) -> Tuple[int, int]:
    return tuple(tf.randint_words(tf.fold_in_words(k1, 1), 2, 0, list(tile)))


def _roll(grids: torch.Tensor, shifts: Sequence[Tuple[int, int]]):
    return torch.stack([torch.roll(g, (-dy, -dx), (0, 1))
                        for g, (dy, dx) in zip(grids, shifts)])


def mcs(grids: torch.Tensor, steps, m: Model,
        precision: str = "float32") -> torch.Tensor:
    """One MCS of the fused sweep for each lane: ``steps`` a list of
    (words, shift), one per lane. Returns the lanes in the new frames."""
    lanes, h, w = grids.shape
    th, tw = m.tile
    gh, gw = h // th, w // tw
    tiles = gh * gw
    k = math.ceil(h * w / tiles)
    iw = tw - 2
    dev = grids.device
    g = _roll(grids, [s for _, s in steps])
    flat = (g.reshape(lanes, gh, th, gw, tw).permute(0, 1, 3, 2, 4)
            .reshape(lanes * tiles, th * tw).clone())
    ctr = (torch.arange(tiles, dtype=torch.int64, device=dev)[:, None] * k
           + torch.arange(k, dtype=torch.int64, device=dev)) & MASK
    here, there, u_act, u_dom = [], [], [], []
    dirs = torch.tensor(DIRS, dtype=torch.int64, device=dev)
    for words, _ in steps:
        x0, x1, x2, x3 = philox(ctr, 0, 0, 0, int(words[0]) & MASK,
                                int(words[1]) & MASK)
        cell = x0 % ((th - 2) * iw)
        d = dirs[x1 % m.neighbourhood]
        r, c = 1 + cell // iw, 1 + cell % iw
        here.append(r * tw + c)
        there.append((r + d[..., 0]) * tw + c + d[..., 1])
        u_act.append((x2 >> 8).to(torch.float32) * 2.0 ** -24)
        u_dom.append((x3 >> 8).to(torch.float32) * 2.0 ** -24)
    here, there = torch.cat(here), torch.cat(there)
    u_act, u_dom = torch.cat(u_act), torch.cat(u_dom)
    rows = torch.arange(lanes * tiles, device=dev)
    for j in range(k):
        a, b = here[:, j], there[:, j]
        s, n = rule(flat[rows, a], flat[rows, b], u_act[:, j], u_dom[:, j],
                    m, precision)
        flat[rows, a] = s
        flat[rows, b] = n
    return (flat.reshape(lanes, gh, gw, th, tw).permute(0, 1, 3, 2, 4)
            .reshape(lanes, h, w))
