"""Elementary-step semantics (port of ``repro.core.rules``, paper
Algorithm 3.2) as a pure pair update on tensors.

    if s == n:                      no-op
    elif u_act < t_eps:             migration        (swap)
    elif u_act < t_eps_mu:          interaction      (probabilistic dominance)
    else:                           reproduction     (fill the empty site)

Interaction uses the padded dominance matrix D (row/col 0 = empty = all
zeros): with p1 = D[s, n], p2 = D[n, s], ``u_dom < p1`` kills the
neighbour and ``u_dom < p1 + p2`` kills the cell.

Float semantics follow the reference exactly: the thresholds are Python
floats that meet float32 draws, so they are rounded to float32 first (JAX's
weak typing), and ``p1 + p2`` is a float32 sum.
"""
from __future__ import annotations

from typing import Tuple

import torch


def apply_pair(s: torch.Tensor, n: torch.Tensor, u_act: torch.Tensor,
               u_dom: torch.Tensor, t_eps: float, t_eps_mu: float,
               dom: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vectorized pure pair update. All args broadcastable; returns the new
    pair in the input cell dtype (int8/int16 lattices widen to int32 and
    narrow back)."""
    cell_dt = s.dtype
    s = s.to(torch.int32)
    n = n.to(torch.int32)
    same = s == n
    te = torch.tensor(t_eps, dtype=torch.float32, device=u_act.device)
    tem = torch.tensor(t_eps_mu, dtype=torch.float32, device=u_act.device)

    migrate = u_act < te
    interact = (u_act >= te) & (u_act < tem)
    reproduce = u_act >= tem

    si, ni = s.long(), n.long()
    p1 = dom[si, ni]
    p2 = dom[ni, si]
    kill_n = interact & (u_dom < p1)
    kill_s = interact & ~kill_n & (u_dom < p1 + p2)

    rep_to_n = reproduce & (n == 0)     # s != n ensures s != 0 here
    rep_to_s = reproduce & (s == 0)

    zero = torch.zeros_like(s)
    new_s = torch.where(migrate, n,
            torch.where(kill_s, zero,
            torch.where(rep_to_s, n, s)))
    new_n = torch.where(migrate, s,
            torch.where(kill_n, zero,
            torch.where(rep_to_n, s, n)))

    new_s = torch.where(same, s, new_s)
    new_n = torch.where(same, n, new_n)
    return new_s.to(cell_dt), new_n.to(cell_dt)


def apply_pair_reference(s: int, n: int, u_act: float, u_dom: float,
                         t_eps: float, t_eps_mu: float,
                         dom) -> Tuple[int, int]:
    """Plain-Python transliteration of paper Algorithm 3.2 (test oracle),
    in Python floats as the reference's own oracle."""
    if s == n:
        return s, n
    if u_act < t_eps:                       # migration
        return n, s
    if u_act < t_eps_mu:                    # interaction
        p1 = float(dom[s, n])
        p2 = float(dom[n, s])
        if u_dom < p1:
            return s, 0                     # neighbour dies
        if u_dom < p1 + p2:
            return 0, n                     # self dies
        return s, n
    # reproduction
    if n == 0:
        return s, s
    if s == 0:
        return n, n
    return s, n
