"""Simulation parameters (port of ``repro.core.params``), without JAX.

The same fields, defaults and JSON form as the reference's ``EscgParams``
(paper Tables 3.1 and 3.2 plus the engine knobs of DESIGN.md §2), so a
params document written by either package loads in the other, and the
same command-line flags (``add_cli_args``, ``params_from_args``), so the
port's ``escg_run`` takes the reference's arguments.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import re
from dataclasses import dataclass
from typing import Optional, Tuple

from .engines import engine_names, validate_params as _validate_engine


def __getattr__(name: str):
    # ``params.ENGINES``: the registry's names, read at each access, so an
    # engine registered after this module loaded is in it
    if name == "ENGINES":
        return engine_names()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


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

    @property
    def proposals_per_round(self) -> int:
        n = self.num_randoms if self.num_randoms > 0 else self.n_cells
        if not self.max_step:
            n = min(n, self.n_cells)
        # paper: numRandoms = (numRandoms / N) * N  (whole MCS)
        return max(self.n_cells, (n // self.n_cells) * self.n_cells)

    @property
    def mcs_per_round(self) -> int:
        return self.proposals_per_round // self.n_cells

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

    @classmethod
    def from_scenario(cls, scenario, engine_config=None,
                      run_config=None) -> "EscgParams":
        """Compose a ``Scenario`` (and optional ``EngineConfig`` and
        ``RunConfig``) into the flat params, as ``scenarios.compose``."""
        from .scenarios import compose  # scenarios imports this module
        return compose(scenario, engine_config, run_config)

    def to_scenario(self, name: str = ""):
        """Split into ``(Scenario, EngineConfig, RunConfig)``:
        ``EscgParams.from_scenario(*p.to_scenario()) == p``."""
        from .scenarios import decompose  # scenarios imports this module
        return decompose(self, name=name)


def _mesh_shape(s: str) -> Tuple[int, int, int]:
    """Parse ``--meshShape P,R,C`` (also 'PxRxC')."""
    parts = [x for x in re.split(r"[,x]", s) if x]
    if len(parts) != 3:
        raise argparse.ArgumentTypeError(
            f"meshShape must be P,R,C (three ints), got {s!r}")
    return tuple(int(x) for x in parts)


def add_cli_args(p: argparse.ArgumentParser) -> None:
    """The reference's flags, names, defaults and choices; ``--engine``
    offers the port's registered engines."""
    b = lambda s: s.lower() in ("1", "true", "yes")  # noqa: E731
    p.add_argument("--length", type=int, default=200)
    p.add_argument("--height", type=int, default=200)
    p.add_argument("--mcs", type=int, default=100_000)
    p.add_argument("--neighbourhood", type=int, default=4, choices=(4, 8))
    p.add_argument("--printFrequency", dest="print_frequency", type=int,
                   default=200)
    p.add_argument("--mobility", type=float, default=3e-5)
    p.add_argument("--species", type=int, default=3)
    p.add_argument("--flux", type=b, default=True)
    p.add_argument("--empty", type=float, default=0.0)
    p.add_argument("--save", type=b, default=False)
    p.add_argument("--dominance", type=str, default="",
                   help="path to dominance .csv (paper --dominance)")
    p.add_argument("--resume", type=b, default=False)
    p.add_argument("--numRandoms", dest="num_randoms", type=int, default=0)
    p.add_argument("--maxStep", dest="max_step", type=b, default=False)
    p.add_argument("--mu", type=float, default=1.0)
    p.add_argument("--sigma", type=float, default=1.0)
    p.add_argument("--epsilon", type=float, default=None)
    p.add_argument("--engine", type=str, default="batched",
                   choices=engine_names())
    p.add_argument("--cellDtype", dest="cell_dtype", type=str,
                   default="int32", choices=("int8", "int16", "int32"))
    p.add_argument("--tile", type=int, nargs=2, default=(8, 32))
    p.add_argument("--shardGrid", dest="shard_grid", type=int, nargs=2,
                   default=None,
                   help="(rows, cols) device grid for engine=sharded; "
                        "omit to auto-factor all devices")
    p.add_argument("--meshShape", dest="mesh_shape", type=_mesh_shape,
                   default=None, metavar="P,R,C",
                   help="composed (pod, rows, cols) device mesh for "
                        "engine=sharded_pod: --trials shard over the pod "
                        "axis, each lattice over (rows, cols); omit to put "
                        "all devices on the pod axis")
    p.add_argument("--localKernel", dest="local_kernel", type=str,
                   default="jnp", choices=("jnp", "pallas", "fused"),
                   help="tile sweep on every block of the sharded "
                        "engines: jnp (plain) and pallas (K3) are "
                        "bit-identical to each other; fused derives "
                        "proposals in-kernel from Philox counters (K1, "
                        "bit-identical to --engine pallas_fused)")
    p.add_argument("--kMcs", dest="k_mcs", type=int, default=1,
                   help="Monte-Carlo steps fused into one kernel launch "
                        "(K2; fused-Philox engines only, bit-identical to "
                        "--kMcs 1)")
    p.add_argument("--observables", type=str, default=None,
                   help="comma-separated streaming observables computed "
                        "on the device into a ring (DESIGN.md §11), e.g. "
                        "'densities,interface_length'; 'none' disables; "
                        "default: off (with --scenario, the preset's "
                        "ScenarioCaps.observables)")
    p.add_argument("--obsCapacity", dest="obs_capacity", type=int,
                   default=0,
                   help="observable ring capacity in rows; 0 = auto (one "
                        "chunk, lossless)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--chunkMcs", dest="chunk_mcs", type=int, default=100)
    p.add_argument("--outDir", dest="out_dir", type=str, default="escg_out")


def parse_observables(s: Optional[str]) -> Optional[Tuple[str, ...]]:
    """``--observables`` string -> tuple ('none'/'' -> (), None -> None:
    the flag was not given, defer to the scenario or the default)."""
    if s is None:
        return None
    s = s.strip()
    if not s or s.lower() == "none":
        return ()
    return tuple(x.strip() for x in s.split(",") if x.strip())


def params_from_args(args: argparse.Namespace) -> EscgParams:
    fields = {f.name for f in dataclasses.fields(EscgParams)}
    kw = {k: v for k, v in vars(args).items() if k in fields and v is not None}
    if "tile" in kw:
        kw["tile"] = tuple(kw["tile"])
    if "observables" in kw:
        kw["observables"] = parse_observables(kw["observables"]) or ()
    for k in ("shard_grid", "mesh_shape"):
        if kw.get(k) is not None:
            kw[k] = tuple(kw[k])
    return EscgParams(**kw).validate()
