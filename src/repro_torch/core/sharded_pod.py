"""Composed pod x grid mesh engine ``sharded_pod`` (port of
``repro.core.sharded_pod``, DESIGN.md §6).

IID trials times domain decomposition, on one ('pod', 'rows', 'cols')
device mesh (``parallel.sharding.PodMesh``): the regime of replication
studies whose lattices are too large for one device. A batch of
``G * n`` trials lays out as :class:`PodBatch`: pod group g owns trials
``g * n .. g * n + n - 1``, whole replicates, and within the group each
replicate is decomposed over the group's ('rows', 'cols') mesh exactly as
the ``sharded`` engine decomposes one lattice: its blocks hold the cells
of all n trials, (n, bh, bw) each (``sharded.ShardedLattice``).

One MCS of the batch is ``sharded.make_local_round_batch`` over every
pod group at once: each block extended by its halo once, then, on each
device, one launch of K1's table form (``'fused'``) or of K3's
(``'pallas'``) over every block of every group there, each trial read at
its own shift with its own stream; the plain sweep of each trial's window
for ``'jnp'``. The counts of every trial are K4s per trial
(``density_counts_sharded_trials``): one launch per device, a ticket per
(group, trial). So a (P, R, C) mesh of one card runs one update launch
and one count launch per MCS, whatever P, R, C and the trial count. With
``k_mcs > 1`` (``'fused'``) a (P, 1, 1) mesh runs K2's trial form once per
pod group and launch group; a larger grid runs K single rounds, each with
K4s per trial.

**Bit-identity for every factorization.** Trial ``t`` is keyed by
``fold_in(key, t)`` and tile ``i`` of its lattice by its global tile id,
never by the pod width, the blocks or the padding, so a (P, R, C) run
equals (1, 1, 1), which equals ``sublattice`` (``'jnp'``, ``'pallas'``) or
``pallas_fused`` (``'fused'``) trial for trial.

``simulate`` runs unchanged: ``one_mcs``/``multi_mcs`` are the
``sharded`` engine's on pod group 0's ('rows', 'cols') mesh.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from ..kernels import ops as kernel_ops
from ..parallel.sharding import PodMesh, pod_lattice_mesh
from . import engines
from . import sharded as sharded_mod
from .sharded import ShardedLattice

__all__ = ["PodBatch", "build_engine"]


class PodBatch(NamedTuple):
    """A trial batch on a :class:`PodMesh`: ``groups[g]`` is pod group
    g's n trials decomposed over ``mesh.group(g)`` (blocks (n, bh, bw))."""
    mesh: PodMesh
    groups: Tuple[ShardedLattice, ...]

    @property
    def device(self) -> torch.device:
        return self.mesh.first


def build_engine(params, dom: torch.Tensor,
                 devices: Optional[Sequence] = None,
                 mesh: Optional[PodMesh] = None) -> engines.BuiltEngine:
    """Build engine ``'sharded_pod'`` for the registry. ``mesh`` defaults
    to ``pod_lattice_mesh`` over ``devices`` (``None``: every visible
    card), shaped by ``params.mesh_shape`` (every device on the pod axis
    when None). Returns both contracts: ``one_mcs``/``multi_mcs`` advance
    one lattice on pod group 0's grid (``simulate``), and the batch
    functions a :class:`PodBatch` of trials (``trials.run_trials``)."""
    from .trials import make_trial_init  # the trial driver imports engines
    p = params.validate()
    th, tw, n_tiles, k_per, _ = engines._tiled_setup(p)
    if mesh is None:
        mesh = pod_lattice_mesh(p.mesh_shape, p.height, p.length, th, tw,
                                devices)
    pw, dr, dc = mesh.shape
    sharded_mod._check_blocks(p.height, p.length, mesh.group(0), (th, tw))
    dom = torch.as_tensor(dom, dtype=torch.float32).to(mesh.first)
    sub = sharded_mod.build_engine(p, dom, mesh=mesh.group(0))
    meshes = tuple(mesh.group(g) for g in range(pw))
    local_round = sharded_mod.make_local_round_batch(p, dom, meshes)
    attempts = torch.tensor(n_tiles * k_per, dtype=torch.int32,
                            device=mesh.first)

    def init_batch(trial_keys):
        """Each pod group's trials born on its group's first device, then
        placed into its blocks; the run keys stay on the host."""
        n = trial_keys.shape[0] // pw
        groups, keys = [], []
        for g, m in enumerate(meshes):
            grids, run_keys = make_trial_init(p, m.first)(
                trial_keys[g * n:(g + 1) * n])
            groups.append(sharded_mod.place(grids, m))
            keys.append(run_keys)
        return PodBatch(mesh, tuple(groups)), torch.cat(keys)

    def one_mcs_batch(batch, words, shifts):
        return (PodBatch(mesh, tuple(local_round(batch.groups, words,
                                                 shifts))),
                attempts.expand(words.shape[0]))

    def counts_batch(batch, species):
        return kernel_ops.density_counts_sharded_trials(
            [g.flat for g in batch.groups], species)

    multi_mcs_batch = None
    if p.local_kernel == "fused" and (dr, dc) == (1, 1):
        t_eps, t_eps_mu = p.action_thresholds()
        tables = {}
        for m in meshes:
            tables.update(sharded_mod._tables(dom, m))

        def multi_mcs_batch(batch, seeds, shifts):
            n = seeds.shape[0] // pw
            groups, counts = [], []
            for g, lat in enumerate(batch.groups):
                block = lat.blocks[0][0]
                rows = slice(g * n, (g + 1) * n)
                dom_d, dirs_d = tables[block.device]
                grids, c = kernel_ops.escg_rounds_fused_trials(
                    block, seeds[rows].to(block.device),
                    shifts[rows].to(block.device), dom_d, dirs_d, (th, tw),
                    k_per, t_eps, t_eps_mu, p.species, p.neighbourhood)
                groups.append(ShardedLattice(lat.mesh, ((grids,),)))
                counts.append(c.to(mesh.first))
            return PodBatch(mesh, tuple(groups)), torch.cat(counts)
    elif p.local_kernel == "fused":
        def multi_mcs_batch(batch, seeds, shifts):
            counts = []
            for k in range(seeds.shape[1]):
                batch, _ = one_mcs_batch(batch, seeds[:, k].contiguous(),
                                         shifts[:, k].contiguous())
                counts.append(counts_batch(batch, p.species))
            return batch, torch.stack(counts, dim=1)

    return sub._replace(
        schedule_batch=sub.schedule, one_mcs_batch=one_mcs_batch,
        multi_mcs_batch=multi_mcs_batch, counts_batch=counts_batch,
        pod_width=pw, init_batch=init_batch, mesh=mesh)
