"""Proposal streams and the sublattice shift draw (port of
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


def tile_stream_batch(key: torch.Tensor, tile_ids: torch.Tensor,
                      k_per_tile: int, interior: int,
                      neighbourhood: int) -> ProposalBatch:
    """Per-tile counter-based proposal streams: tile ``t``'s draws depend
    only on ``(key, global tile id)``, as in the reference, where this is
    ``jax.vmap`` over the tile ids of ``split(fold_in(key, tid), 4)``,
    two ``randint`` and two ``uniform`` draws of ``k_per_tile`` values.
    Returns (len(tile_ids), K) fields on the key's device."""
    keys = threefry.split_batch(threefry.fold_in_batch(key, tile_ids), 4)
    return ProposalBatch(
        cell=threefry.randint_batch(keys[:, 0], k_per_tile, 0, interior),
        dirn=threefry.randint_batch(keys[:, 1], k_per_tile, 0,
                                    neighbourhood),
        u_act=threefry.uniform_batch(keys[:, 2], k_per_tile),
        u_dom=threefry.uniform_batch(keys[:, 3], k_per_tile))


def round_shift(key: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """Uniform torus shift (dy, dx) in [0,th) x [0,tw) for one sublattice
    round (Shim-Amar randomized sublattice origin), drawn on the key's
    device."""
    return threefry.randint(key, (2,), 0, torch.tensor([th, tw]),
                            device=key.device)
