"""Admission bucketing (port of ``repro.serve.bucketing``, DESIGN.md
§12): which requests may share a batch.

Two requests can ride one built engine only when every knob that shapes
it matches: engine + local kernel + k_mcs select the kernels, lattice
extent / tile / species / cell dtype / device layout fix the tensors'
shapes, and chunk_mcs + the observable set fix the chunk schedule and
the ring's row layout. Those fields form the :class:`BucketKey`. Physics
(dominance network, action rates, boundary) are bound into the built
engine's closures, so batches also group by the scenario content hash
(``scenarios.scenario_key``): the (bucket, scenario_key) pair is the
engine cache's key. Seed, MCS budget and trial count are left out on
purpose: they vary per request within a batch (per-trial fold-in keys;
per-request chunk-boundary accounting in the executor).
"""
from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from ..core.params import EscgParams
from .protocol import SimRequest

__all__ = ["BucketKey", "bucket_key", "Pending", "AdmissionQueue"]


class BucketKey(NamedTuple):
    """The built-engine identity of a request (module docstring)."""
    engine: str
    local_kernel: str
    k_mcs: int
    tile: Tuple[int, int]
    height: int
    length: int
    species: int
    cell_dtype: str
    mesh_shape: Optional[Tuple[int, int, int]]
    shard_grid: Optional[Tuple[int, int]]
    chunk_mcs: int
    observables: Tuple[str, ...]
    obs_capacity: int

    def short(self) -> str:
        """Human-readable form for responses / accounting."""
        return (f"{self.engine}/{self.local_kernel}"
                f"/k{self.k_mcs}/{self.height}x{self.length}"
                f"/S{self.species}/{self.cell_dtype}"
                f"/tile{self.tile[0]}x{self.tile[1]}"
                f"/chunk{self.chunk_mcs}"
                + (f"/obs{len(self.observables)}" if self.observables
                   else ""))


def bucket_key(p: EscgParams) -> BucketKey:
    """The admission bucket of resolved params (post ``resolve_config``,
    so scenario-declared observables are already folded in)."""
    return BucketKey(
        engine=p.engine, local_kernel=p.local_kernel, k_mcs=p.k_mcs,
        tile=tuple(p.tile), height=p.height, length=p.length,
        species=p.species, cell_dtype=p.cell_dtype,
        mesh_shape=(tuple(p.mesh_shape) if p.mesh_shape is not None
                    else None),
        shard_grid=(tuple(p.shard_grid) if p.shard_grid is not None
                    else None),
        chunk_mcs=p.chunk_mcs, observables=tuple(p.observables),
        obs_capacity=p.obs_capacity)


@dataclass
class Pending:
    """One admitted request waiting in its bucket group."""
    seq: int
    req: SimRequest
    params: EscgParams             # resolved + validated
    dom: np.ndarray
    bucket: BucketKey
    scenario_key: str
    kind: str                      # 'pod' | 'vmap' | 'single'
    n_mcs: int
    # strict-schedule token: normally None (any same-bucket MCS budgets
    # pack — trajectories and per-MCS stats are chunk-schedule invariant);
    # set to the MCS budget when k_mcs > 1 streams grid-derived (lag-held)
    # observables, whose rows DO depend on launch-group boundaries — only
    # identical schedules may then share a batch (DESIGN.md §12)
    sched: Optional[int] = None
    t_submit: float = field(default_factory=time.perf_counter)

    @property
    def group(self) -> Tuple[BucketKey, str, Optional[int]]:
        return (self.bucket, self.scenario_key, self.sched)


class AdmissionQueue:
    """FIFO-of-groups queue: requests group by (bucket, scenario_key);
    the drain policy (``pop_batch``) picks by age unless a group has
    accumulated a full batch, in which case occupancy wins — the same
    age/occupancy rule continuous-batching LM servers use."""

    def __init__(self) -> None:
        self._groups: "OrderedDict[Tuple, List[Pending]]" = OrderedDict()
        self._n_pending = 0

    def __len__(self) -> int:
        return self._n_pending

    def push(self, pending: Pending) -> None:
        self._groups.setdefault(pending.group, []).append(pending)
        self._n_pending += 1

    def depth(self) -> Dict[str, int]:
        """Trials queued per group (accounting surface). The key carries
        the FULL group identity — bucket, full scenario hash and the
        strict-schedule token — so two live groups can never collapse
        into (and overwrite) one reported entry."""
        out: Dict[str, int] = {}
        for (b, sk, sched), plist in self._groups.items():
            key = f"{b.short()}@{sk}"
            if sched is not None:
                key += f"/sched{sched}"
            out[key] = self._trials(plist)
        return out

    def _trials(self, plist: List[Pending]) -> int:
        return sum(max(1, p.req.n_trials) for p in plist)

    def pop_batch(self, max_batch_trials: int
                  ) -> Optional[Tuple[Tuple, List[Pending]]]:
        """The next batch to run: all of one group up to
        ``max_batch_trials`` trials (always at least one request).

        Policy: any group holding >= max_batch_trials trials is drained
        first (occupancy — a full pod beats fairness); otherwise the
        group containing the OLDEST pending request runs (age — no
        request starves behind a popular bucket)."""
        if not self._groups:
            return None
        full = [g for g, plist in self._groups.items()
                if self._trials(plist) >= max_batch_trials]
        if full:
            gkey = max(full, key=lambda g: self._trials(self._groups[g]))
        else:
            gkey = min(self._groups,
                       key=lambda g: self._groups[g][0].seq)
        plist = self._groups[gkey]
        take, trials = [], 0
        while plist and (not take
                         or trials + max(1, plist[0].req.n_trials)
                         <= max_batch_trials):
            p = plist.pop(0)
            take.append(p)
            trials += max(1, p.req.n_trials)
        if not plist:
            del self._groups[gkey]
        self._n_pending -= len(take)
        return gkey, take
