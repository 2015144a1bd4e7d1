"""Proposal containers and the sublattice shift draw (port of
``repro.core.rng``, paper §3.2.1)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import threefry


class ProposalBatch(NamedTuple):
    """One round of elementary-step proposals, each field (T, K) for the
    tiled engines."""
    cell: torch.Tensor    # int32  interior cell index of each tile
    dirn: torch.Tensor    # int32  direction id in [0, nbhd)
    u_act: torch.Tensor   # float32 action draw in [0, 1)
    u_dom: torch.Tensor   # float32 dominance draw in [0, 1)


def round_shift(key: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """Uniform torus shift (dy, dx) in [0,th) x [0,tw) for one sublattice
    round (Shim-Amar randomized sublattice origin), drawn on the key's
    device."""
    return threefry.randint(key, (2,), 0, torch.tensor([th, tw]),
                            device=key.device)
