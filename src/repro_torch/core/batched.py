"""E2: the batched "maxStep" engine's arbitration window (port of
``repro.core.batched``, paper §2.6, §3.2.2, §3.3).

The paper's CUDA code lets hardware atomics settle contested cells; the
reference arbitrates deterministically with a scatter-min of the proposal
index over both touched cells: the earliest proposal touching a cell wins
it, and a proposal survives only if it won both of its cells. Survivors
are pairwise disjoint and are applied with one masked scatter; losers are
dropped and counted. A min does not depend on the order of the scatter,
so ``scatter_reduce_(..., "amin")`` gives the same winners on the card as
on the CPU. The reference leaves this to XLA's scatter and has no Pallas
kernel for it, so it is plain PyTorch here too.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import lattice
from .rng import ProposalBatch
from .rules import apply_pair


def run_proposals(grid: torch.Tensor, batch: ProposalBatch, t_eps: float,
                  t_eps_mu: float, dom: torch.Tensor, flux: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply one arbitration window of (B,) proposals in parallel.

    Returns ``(grid, kept)``, ``kept`` an int32 scalar on the grid's
    device. Bit-identical to ``reference.run_proposals(...,
    drop_conflicts=True)``."""
    h, w = grid.shape
    n = h * w
    g = grid.reshape(-1)
    i = batch.cell.long()
    ni = lattice.neighbor_index(batch.cell, batch.dirn, h, w, flux).long()
    b = i.shape[0]
    order = torch.arange(b, dtype=torch.int32, device=g.device)

    # arbitration: the first proposal to touch a cell owns it
    winner = torch.full((n,), b, dtype=torch.int32, device=g.device)
    winner.scatter_reduce_(0, i, order, "amin", include_self=True)
    winner.scatter_reduce_(0, ni, order, "amin", include_self=True)
    keep = (winner[i] == order) & (winner[ni] == order)

    # the rule on the original grid (survivors are disjoint)
    ns, nn = apply_pair(g[i], g[ni], batch.u_act, batch.u_dom, t_eps,
                        t_eps_mu, dom)

    # masked scatter: dropped proposals write to a shadow slot at n
    gpad = torch.cat([g, g.new_zeros(1)])
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    gpad.index_put_((torch.where(keep, i, n),), torch.where(keep, ns, zero))
    gpad.index_put_((torch.where(keep, ni, n),), torch.where(keep, nn, zero))
    return gpad[:n].reshape(h, w), keep.sum(dtype=torch.int32)


def run_proposals_trials(grids: torch.Tensor, batch: ProposalBatch,
                         t_eps: float, t_eps_mu: float, dom: torch.Tensor,
                         flux: bool = True
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One arbitration window of each trial of an (n, H, W) batch, with
    (n, B) proposals, as one scatter-min over the stacked lattices: trial
    t's cells are offset by t * H * W and its proposals keep their order
    within the trial. Trials share no cell and a min does not depend on
    order, so trial t equals ``run_proposals(grids[t], batch[t], ...)``.
    Returns ``(grids, kept (n,) int32)``."""
    n, h, w = grids.shape
    cells = h * w
    g = grids.reshape(-1)
    off = (torch.arange(n, device=g.device) * cells)[:, None]
    i = batch.cell.long() + off
    ni = lattice.neighbor_index(batch.cell, batch.dirn, h, w,
                                flux).long() + off
    b = i.shape[1]
    order = torch.arange(b, dtype=torch.int32,
                         device=g.device).expand(n, b)

    winner = torch.full((n * cells,), b, dtype=torch.int32, device=g.device)
    winner.scatter_reduce_(0, i.reshape(-1), order.reshape(-1), "amin",
                           include_self=True)
    winner.scatter_reduce_(0, ni.reshape(-1), order.reshape(-1), "amin",
                           include_self=True)
    keep = (winner[i] == order) & (winner[ni] == order)

    ns, nn = apply_pair(g[i], g[ni], batch.u_act, batch.u_dom, t_eps,
                        t_eps_mu, dom)

    shadow = n * cells
    gpad = torch.cat([g, g.new_zeros(1)])
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    gpad.index_put_((torch.where(keep, i, shadow),),
                    torch.where(keep, ns, zero))
    gpad.index_put_((torch.where(keep, ni, shadow),),
                    torch.where(keep, nn, zero))
    return (gpad[:shadow].reshape(n, h, w),
            keep.sum(dim=1, dtype=torch.int32))
