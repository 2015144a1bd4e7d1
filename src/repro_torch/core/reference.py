"""E1: the exact sequential engine (port of ``repro.core.reference``,
paper Algorithm 3.2/3.3): the single-threaded baseline the paper
benchmarks against, and the oracle every parallel engine is held to.

``drop_conflicts=True`` is the sequential shadow of the batched engine: a
proposal is skipped when an earlier proposal of the same window touched
either of its cells, and its cells count as touched all the same. With
matching windows this equals ``batched.run_proposals`` bit for bit.

On the card the scan is kernel S1 (``kernels/reference_scan.py``), one
block walking the stream in windows that it applies in parallel where no
two steps share a cell and in order where they do; on the CPU it is that
kernel's plain version, a host loop, which suits small lattices only.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .lattice import DIRS
from .rng import ProposalBatch


def run_proposals(grid: torch.Tensor, batch: ProposalBatch, t_eps: float,
                  t_eps_mu: float, dom: torch.Tensor, flux: bool = True,
                  drop_conflicts: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply a (B,) proposal stream strictly in order. Returns ``(grid,
    kept)``, ``kept`` the applied count as an int32 scalar on the grid's
    device."""
    from ..kernels.reference_scan import reference_scan  # kernels import core
    dirs = torch.as_tensor(DIRS).to(grid.device)
    return reference_scan(grid, *batch, dom, dirs, t_eps, t_eps_mu, flux,
                          drop_conflicts)
