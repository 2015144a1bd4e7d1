"""Proposal streams and the sublattice shift draw (port of
``repro.core.rng``, paper §3.2.1).

Each function takes one key (2,) or a batch of keys (n, 2), one per
trial; a batch gives every field a leading trial axis and equals the
single-key function stacked over the keys, as ``jax.vmap`` of the
reference's does."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import threefry
from .device import DeviceLike


class ProposalBatch(NamedTuple):
    """One round of elementary-step proposals: each field (B,) for the
    ``reference`` and ``batched`` engines, with ``cell`` a flat lattice
    index, and (T, K) for the tiled engines, with ``cell`` an index into
    each tile's interior."""
    cell: torch.Tensor    # int32  flat or interior cell index
    dirn: torch.Tensor    # int32  direction id in [0, nbhd)
    u_act: torch.Tensor   # float32 action draw in [0, 1)
    u_dom: torch.Tensor   # float32 dominance draw in [0, 1)


def proposal_batch(key: torch.Tensor, n_proposals: int, n_cells: int,
                   neighbourhood: int,
                   device: Optional[DeviceLike] = None) -> ProposalBatch:
    """One batch of proposals over the whole lattice (the paper's
    refreshRandomNumbers): ``split(key, 4)``, then ``cell`` in [0, N),
    ``dirn`` in [0, nbhd) and the two uniforms, each (n_proposals,), drawn
    on ``device`` (default: the key's device). A host key keeps its own
    splits off the card while the draws land on it. Keys (n, 2) give
    fields (n, n_proposals)."""
    device = key.device if device is None else device
    if key.dim() == 2:
        sub = threefry.split_batch(key.to(device), 4)
        return ProposalBatch(
            cell=threefry.randint_batch(sub[:, 0], n_proposals, 0, n_cells),
            dirn=threefry.randint_batch(sub[:, 1], n_proposals, 0,
                                        neighbourhood),
            u_act=threefry.uniform_batch(sub[:, 2], n_proposals),
            u_dom=threefry.uniform_batch(sub[:, 3], n_proposals))
    k1, k2, k3, k4 = threefry.split(key, 4)
    n = (n_proposals,)
    return ProposalBatch(
        cell=threefry.randint(k1, n, 0, n_cells, device=device),
        dirn=threefry.randint(k2, n, 0, neighbourhood, device=device),
        u_act=threefry.uniform(k3, n, device=device),
        u_dom=threefry.uniform(k4, n, device=device))


def tile_stream_batch(key: torch.Tensor, tile_ids: torch.Tensor,
                      k_per_tile: int, interior: int,
                      neighbourhood: int) -> ProposalBatch:
    """Per-tile counter-based proposal streams: tile ``t``'s draws depend
    only on ``(key, global tile id)``, as in the reference, where this is
    ``jax.vmap`` over the tile ids of ``split(fold_in(key, tid), 4)``,
    two ``randint`` and two ``uniform`` draws of ``k_per_tile`` values.
    Returns (len(tile_ids), K) fields on the key's device; keys (n, 2)
    give (n, len(tile_ids), K)."""
    if key.dim() == 2:
        key = key[:, None, :]
    keys = threefry.split_batch(threefry.fold_in_batch(key, tile_ids), 4)
    return ProposalBatch(
        cell=threefry.randint_batch(keys[..., 0, :], k_per_tile, 0,
                                    interior),
        dirn=threefry.randint_batch(keys[..., 1, :], k_per_tile, 0,
                                    neighbourhood),
        u_act=threefry.uniform_batch(keys[..., 2, :], k_per_tile),
        u_dom=threefry.uniform_batch(keys[..., 3, :], k_per_tile))


def round_shift(key: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """Uniform torus shift (dy, dx) in [0,th) x [0,tw) for one sublattice
    round (Shim-Amar randomized sublattice origin), drawn on the key's
    device; keys (n, 2) give shifts (n, 2)."""
    if key.dim() == 2:
        return threefry.randint_batch(key, 2, 0, (th, tw))
    return threefry.randint(key, (2,), 0, torch.tensor([th, tw]),
                            device=key.device)
