"""Simulation parameters (port of ``repro.core.params``), without JAX.

The same fields, defaults and JSON form as the reference's ``EscgParams``
(paper Tables 3.1 and 3.2 plus the engine knobs of DESIGN.md §2), so a
params document written by either package loads in the other.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Optional, Tuple

from .engines import validate_params as _validate_engine


@dataclass(frozen=True)
class EscgParams:
    # ---- paper Table 3.1 ----
    length: int = 200              # lattice width  W
    height: int = 200              # lattice height H
    mcs: int = 100_000             # Monte Carlo step limit
    neighbourhood: int = 4         # 4 = von Neumann, 8 = Moore
    print_frequency: int = 200     # density print interval (MCS)
    mobility: float = 3e-5         # M: typical area explored per unit time
    species: int = 3
    flux: bool = True              # periodic (wrap) boundary; False = reflect
    empty: float = 0.0             # initial empty-cell probability
    save: bool = False             # export snapshots/state
    # ---- paper Table 3.2 (GPU extensions) ----
    resume: bool = False
    num_randoms: int = 0           # proposals per round; 0 -> N (one MCS/round)
    max_step: bool = False         # multiple MCS per round (maxStep mode)
    # ---- action rates (paper §3.1.1) ----
    mu: float = 1.0                # interaction
    sigma: float = 1.0             # reproduction
    epsilon: Optional[float] = None  # migration; default 2*M*N (paper)
    # ---- engine knobs ----
    engine: str = "batched"        # any registered engine (engines.py)
    cell_dtype: str = "int32"      # int8/int16 shrink the lattice
    tile: Tuple[int, int] = (8, 32)   # sublattice tile (th, tw)
    seed: int = 0
    chunk_mcs: int = 100           # MCS per chunk between host checks
    out_dir: str = "escg_out"
    shard_grid: Optional[Tuple[int, int]] = None
    mesh_shape: Optional[Tuple[int, int, int]] = None
    local_kernel: str = "jnp"
    k_mcs: int = 1                 # MCS per kernel launch (fused engine)
    observables: Tuple[str, ...] = ()
    obs_capacity: int = 0

    @property
    def n_cells(self) -> int:
        return self.length * self.height

    @property
    def eps(self) -> float:
        if self.epsilon is not None:
            return float(self.epsilon)
        return 2.0 * self.mobility * self.n_cells

    def action_thresholds(self) -> Tuple[float, float]:
        """Normalized cumulative thresholds (t_eps, t_eps_mu) on u ~ U[0,1):
        u < t_eps migrates, u < t_eps_mu interacts, else reproduces (paper
        Algorithm 3.2 ordering)."""
        total = self.mu + self.sigma + self.eps
        if total <= 0:
            raise ValueError("mu + sigma + epsilon must be positive")
        return self.eps / total, (self.eps + self.mu) / total

    def validate(self) -> "EscgParams":
        if self.neighbourhood not in (4, 8):
            raise ValueError("neighbourhood must be 4 or 8")
        if self.species < 1:
            raise ValueError("species >= 1")
        if not (0.0 <= self.empty <= 1.0):
            raise ValueError("empty in [0,1]")
        if self.length < 3 or self.height < 3:
            raise ValueError("lattice must be at least 3x3")
        if self.cell_dtype not in ("int8", "int16", "int32"):
            raise ValueError("cell_dtype must be int8/int16/int32")
        if self.cell_dtype == "int8" and self.species > 127:
            raise ValueError("int8 lattice supports <= 127 species")
        _validate_engine(self)
        return self

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @staticmethod
    def from_json(s: str) -> "EscgParams":
        d = json.loads(s)
        d["tile"] = tuple(d["tile"])
        for k in ("shard_grid", "mesh_shape", "observables"):
            if d.get(k) is not None:
                d[k] = tuple(d[k])
        return EscgParams(**d)

    def replace(self, **kw) -> "EscgParams":
        return dataclasses.replace(self, **kw)
