"""Scenario layer (port of ``repro.core.scenarios``, DESIGN.md §10).

* :class:`Scenario` — the physics of one study (species, dominance,
  rates, boundary, neighbourhood, initial occupancy);
* :class:`EngineConfig` — engine selection and layout;
* :class:`RunConfig` — lattice extent, MCS budget, chunking, seed.

``compose`` assembles the three into ``EscgParams`` and ``decompose``
splits one back; ``scenario_key`` hashes a scenario's physics. The JSON
forms are the reference's, field for field. The presets are the
reference's, registered in its order with its capability texts (the
README's scenario matrix is generated from them): ``park3``,
``zhong_density``, the parametric ``nspecies`` family, ``probabilistic``
(Park's eight species) and ``asym_rps``. ``scenario_from_cli``,
``engine_config_from_args`` and ``run_config_from_args`` bridge the
command line (``launch/escg_run.py``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import inspect
import json
import re
from dataclasses import dataclass, field
from typing import Callable, Dict, Mapping, Optional, Tuple, Union

import numpy as np

from . import dominance as dom_mod
from .engines import get_engine
from .observables import observable_names
from .params import EscgParams, parse_observables

__all__ = [
    "Scenario", "ScenarioCaps", "ScenarioSpec", "EngineConfig", "RunConfig",
    "register_scenario", "scenario_names", "scenario_specs", "get_scenario",
    "make_scenario", "compose", "decompose", "resolve_config",
    "scenario_key", "scenario_observables", "scenario_from_cli",
    "engine_config_from_args", "run_config_from_args",
    "SCENARIO_CLI_FIELDS",
]

BOUNDARIES = ("flux", "reflect")   # periodic torus | reflecting walls


def _freeze_extras(extras) -> Tuple[Tuple[str, float], ...]:
    items = extras.items() if isinstance(extras, Mapping) else extras
    return tuple(sorted((str(k), float(v)) for k, v in items))


@dataclass(frozen=True)
class Scenario:
    """What is simulated: the physics of one ESCG study. The dominance
    network is derived from ``name`` through the registry (ad-hoc or
    unregistered names: the circulant C(S, {1}))."""
    name: str = ""
    species: int = 3
    neighbourhood: int = 4
    mobility: float = 3e-5
    mu: float = 1.0
    sigma: float = 1.0
    epsilon: Optional[float] = None
    boundary: str = "flux"
    empty: float = 0.0
    extras: Tuple[Tuple[str, float], ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "extras", _freeze_extras(self.extras))

    @property
    def flux(self) -> bool:
        return self.boundary == "flux"

    def extra(self, key: str, default: Optional[float] = None) -> float:
        """A preset's extra knob (Park's alpha, asym_rps's r12, ...)."""
        for k, v in self.extras:
            if k == key:
                return v
        if default is None:
            raise KeyError(f"scenario {self.name!r} has no extra {key!r}")
        return float(default)

    def validate(self) -> "Scenario":
        if self.boundary not in BOUNDARIES:
            raise ValueError(f"boundary must be one of {BOUNDARIES}, "
                             f"got {self.boundary!r}")
        if self.species < 1:
            raise ValueError("species >= 1")
        if self.neighbourhood not in (4, 8):
            raise ValueError("neighbourhood must be 4 or 8")
        if not (0.0 <= self.empty <= 1.0):
            raise ValueError("empty in [0,1]")
        spec = _spec_for(self.name)
        if spec is not None and spec.caps.species is not None \
                and self.species != spec.caps.species:
            raise ValueError(
                f"scenario {self.name!r} is a fixed {spec.caps.species}-"
                f"species study; cannot override species={self.species}")
        return self

    def dominance(self) -> np.ndarray:
        """The (S+1, S+1) dominance network of this scenario."""
        spec = _spec_for(self.name)
        if spec is not None and spec.dominance is not None:
            return spec.dominance(self)
        return dom_mod.circulant(self.species)

    def replace(self, **kw) -> "Scenario":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @staticmethod
    def from_json(s: str) -> "Scenario":
        d = json.loads(s)
        d["extras"] = _freeze_extras(d.get("extras", ()))
        return Scenario(**d)


@dataclass(frozen=True)
class EngineConfig:
    """How one MCS is computed: engine selection and device layout."""
    engine: str = "batched"
    cell_dtype: str = "int32"
    tile: Tuple[int, int] = (8, 32)
    shard_grid: Optional[Tuple[int, int]] = None
    mesh_shape: Optional[Tuple[int, int, int]] = None
    local_kernel: str = "jnp"
    k_mcs: int = 1

    def replace(self, **kw) -> "EngineConfig":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @staticmethod
    def from_json(s: str) -> "EngineConfig":
        d = json.loads(s)
        d["tile"] = tuple(d["tile"])
        for k in ("shard_grid", "mesh_shape"):
            if d.get(k) is not None:
                d[k] = tuple(d[k])
        return EngineConfig(**d)


@dataclass(frozen=True)
class RunConfig:
    """How long and where: run control, lattice extent and IO.
    ``observables=None`` defers to the scenario's declared streams, ``()``
    turns them off."""
    length: int = 200
    height: int = 200
    mcs: int = 100_000
    chunk_mcs: int = 100
    seed: int = 0
    print_frequency: int = 200
    num_randoms: int = 0
    max_step: bool = False
    save: bool = False
    resume: bool = False
    out_dir: str = "escg_out"
    observables: Optional[Tuple[str, ...]] = None
    obs_capacity: int = 0

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @staticmethod
    def from_json(s: str) -> "RunConfig":
        d = json.loads(s)
        if d.get("observables") is not None:
            d["observables"] = tuple(d["observables"])
        return RunConfig(**d)


# ------------------------------- registry ---------------------------------- #

@dataclass(frozen=True)
class ScenarioCaps:
    """Static capability metadata of a preset, read by validation and the
    scenario matrix."""
    species: Optional[int] = None  # fixed species count; None = parametric
    rates: str = "deterministic"   # dominance entries: {0,1} or [0,1] rates
    boundary: str = "flux"         # boundary condition the study assumes
    init: str = "uniform"          # initial-condition sampler family
    observables: Tuple[str, ...] = ()  # the statistics the study reads
    description: str = ""
    paper: str = ""                # study / figure the preset reproduces


@dataclass(frozen=True)
class ScenarioSpec:
    name: str
    caps: ScenarioCaps
    build: Callable[..., Scenario] = field(repr=False, default=None)
    dominance: Optional[Callable[[Scenario], np.ndarray]] = field(
        repr=False, default=None)


_REGISTRY: Dict[str, ScenarioSpec] = {}


def register_scenario(name: str, caps: ScenarioCaps,
                      dominance: Optional[Callable[[Scenario], np.ndarray]]
                      = None):
    """Decorator: register ``build(**overrides) -> Scenario``."""
    def deco(build_fn):
        _REGISTRY[name] = ScenarioSpec(name=name, caps=caps, build=build_fn,
                                       dominance=dominance)
        return build_fn
    return deco


def scenario_names() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


def scenario_specs() -> Tuple[ScenarioSpec, ...]:
    return tuple(_REGISTRY.values())


_PARAMETRIC = re.compile(r"^([A-Za-z_]+?)(\d+)$")


def _resolve_name(name: str):
    """(spec, extra_kwargs) for ``name``; parametric families resolve by
    suffix: 'nspecies7' -> the 'nspecies' family with S=7."""
    if name in _REGISTRY:
        return _REGISTRY[name], {}
    m = _PARAMETRIC.match(name)
    if m and m.group(1) in _REGISTRY \
            and _REGISTRY[m.group(1)].caps.species is None:
        return _REGISTRY[m.group(1)], {"S": int(m.group(2))}
    raise ValueError(
        f"unknown scenario {name!r}; registered: {scenario_names()} "
        "(parametric families accept a numeric suffix, e.g. 'nspecies7')")


def _spec_for(name: str) -> Optional[ScenarioSpec]:
    if not name:
        return None
    try:
        return _resolve_name(name)[0]
    except ValueError:
        return None


def get_scenario(name: str) -> ScenarioSpec:
    return _resolve_name(name)[0]


def make_scenario(name: str, **overrides) -> Scenario:
    """Build a registered preset. Overrides that the preset's function
    declares go to it; plain ``Scenario`` field names are applied on
    top."""
    spec, kw = _resolve_name(name)
    accepts = {p.name for p in inspect.signature(spec.build)
               .parameters.values()
               if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)}
    field_names = {f.name for f in dataclasses.fields(Scenario)}
    build_kw, field_kw = {}, {}
    for k, v in overrides.items():
        if k in accepts:
            build_kw[k] = v
        elif k in field_names:
            field_kw[k] = v
        else:
            raise ValueError(
                f"scenario {name!r} accepts preset knobs {sorted(accepts)}"
                f" and Scenario fields {sorted(field_names)}; got {k!r}")
    sc = spec.build(**kw, **build_kw)
    if field_kw:
        sc = sc.replace(**field_kw)
    return sc.validate()


# ------------------------------ composition -------------------------------- #

def compose(scenario: Scenario, engine: Optional[EngineConfig] = None,
            run: Optional[RunConfig] = None) -> EscgParams:
    """Assemble (Scenario, EngineConfig, RunConfig) into a validated
    ``EscgParams``."""
    engine = engine or EngineConfig()
    run = run or RunConfig()
    scenario = scenario.validate()
    if get_engine(engine.engine).caps.flux_only and not scenario.flux:
        raise ValueError(
            f"scenario {scenario.name or '<ad-hoc>'!r} uses reflecting "
            f"boundaries but engine {engine.engine!r} is flux-only")
    return EscgParams(
        length=run.length, height=run.height, mcs=run.mcs,
        neighbourhood=scenario.neighbourhood,
        print_frequency=run.print_frequency, mobility=scenario.mobility,
        species=scenario.species, flux=scenario.flux, empty=scenario.empty,
        save=run.save, resume=run.resume, num_randoms=run.num_randoms,
        max_step=run.max_step, mu=scenario.mu, sigma=scenario.sigma,
        epsilon=scenario.epsilon, engine=engine.engine,
        cell_dtype=engine.cell_dtype, tile=engine.tile, seed=run.seed,
        chunk_mcs=run.chunk_mcs, out_dir=run.out_dir,
        shard_grid=engine.shard_grid, mesh_shape=engine.mesh_shape,
        local_kernel=engine.local_kernel, k_mcs=engine.k_mcs,
        observables=(() if run.observables is None
                     else tuple(run.observables)),
        obs_capacity=run.obs_capacity).validate()


def decompose(params: EscgParams, name: str = ""
              ) -> Tuple[Scenario, EngineConfig, RunConfig]:
    """Split a flat ``EscgParams`` into the three layers:
    ``compose(*decompose(p)) == p`` for every valid ``p``."""
    sc = Scenario(
        name=name, species=params.species,
        neighbourhood=params.neighbourhood, mobility=params.mobility,
        mu=params.mu, sigma=params.sigma, epsilon=params.epsilon,
        boundary="flux" if params.flux else "reflect", empty=params.empty)
    eng = EngineConfig(
        engine=params.engine, cell_dtype=params.cell_dtype,
        tile=params.tile, shard_grid=params.shard_grid,
        mesh_shape=params.mesh_shape, local_kernel=params.local_kernel,
        k_mcs=params.k_mcs)
    run = RunConfig(
        length=params.length, height=params.height, mcs=params.mcs,
        chunk_mcs=params.chunk_mcs, seed=params.seed,
        print_frequency=params.print_frequency,
        num_randoms=params.num_randoms, max_step=params.max_step,
        save=params.save, resume=params.resume, out_dir=params.out_dir,
        observables=tuple(params.observables),
        obs_capacity=params.obs_capacity)
    return sc, eng, run


def scenario_key(scenario: Scenario) -> str:
    """Stable content hash of a scenario's physics: SHA-256 of the
    canonical JSON of its fields (sorted keys, the extras sorted), the
    reference's, so both packages give a scenario the same key."""
    payload = json.dumps(dataclasses.asdict(scenario), sort_keys=True,
                         separators=(",", ":"))
    return hashlib.sha256(payload.encode("utf-8")).hexdigest()[:16]


def resolve_config(params: Union[EscgParams, Scenario],
                   dom: Optional[np.ndarray] = None,
                   engine_config: Optional[EngineConfig] = None,
                   run_config: Optional[RunConfig] = None):
    """Normalize the config input of ``simulate`` or ``engines.build`` to ``(EscgParams, dom)``. For a
    scenario, ``dom=None`` takes the registry's network, and unless the
    ``RunConfig`` pins ``observables`` the scenario's declared streaming
    observables are requested, as in the reference."""
    if isinstance(params, Scenario):
        if dom is None:
            dom = params.dominance()
        composed = compose(params, engine_config, run_config)
        if run_config is None or run_config.observables is None:
            obs = scenario_observables(params.name)
            if obs:
                composed = composed.replace(observables=obs).validate()
        return composed, dom
    if engine_config is not None or run_config is not None:
        raise ValueError(
            "engine/run configs only apply when the first argument is a "
            "Scenario; an EscgParams already carries both layers")
    return params, dom


def scenario_observables(name: str) -> Tuple[str, ...]:
    """The streaming subset of a scenario's declared observables, in
    declaration order (result-level statistics such as ``stasis_mcs`` are
    not streams). Ad-hoc scenarios: ()."""
    spec = _spec_for(name)
    if spec is None:
        return ()
    streams = observable_names()
    return tuple(o for o in spec.caps.observables if o in streams)


# ------------------------------ CLI bridging ------------------------------- #

# Scenario-owned CLI fields: with --scenario these come from the preset
# unless the flag is given with a value other than the parser's default
# (a flag re-passed at its default defers to the preset, as in the
# reference).
SCENARIO_CLI_FIELDS = ("species", "neighbourhood", "mobility", "mu",
                       "sigma", "epsilon", "empty", "flux")


def scenario_from_cli(args, parser) -> Scenario:
    """The ``--scenario`` preset, overridden by the scenario-owned flags
    that differ from ``parser``'s defaults (``SCENARIO_CLI_FIELDS``)."""
    sc = make_scenario(args.scenario)
    over = {}
    for f in SCENARIO_CLI_FIELDS:
        v = getattr(args, f, None)
        if v is None or v == parser.get_default(f):
            continue
        over[f] = v
    if "flux" in over:
        over["boundary"] = "flux" if over.pop("flux") else "reflect"
    return sc.replace(**over).validate() if over else sc


def engine_config_from_args(args) -> EngineConfig:
    kw = {}
    for f in dataclasses.fields(EngineConfig):
        v = getattr(args, f.name, None)
        if v is not None:
            kw[f.name] = tuple(v) if isinstance(v, list) else v
    return EngineConfig(**kw)


def run_config_from_args(args) -> RunConfig:
    kw = {}
    for f in dataclasses.fields(RunConfig):
        v = getattr(args, f.name, None)
        if v is not None:
            kw[f.name] = v
    if "observables" in kw:
        # a comma-separated string on the command line; an absent flag
        # (None) keeps the defer-to-scenario default
        kw["observables"] = parse_observables(kw["observables"])
    return RunConfig(**kw)


# ------------------------------ presets ------------------------------------ #

@register_scenario("park3", ScenarioCaps(
    species=3, rates="deterministic",
    observables=("densities", "interface_length", "stasis_mcs"),
    description="paper baseline rock-paper-scissors: cyclic C(3,{1}) "
                "dominance at low mobility (RMF spiral regime)",
    paper="Tables 3.1/3.2; Reichenbach-Mobilia-Frey Fig 1.1"),
    dominance=lambda sc: dom_mod.RPS())
def _build_park3() -> Scenario:
    return Scenario(name="park3", species=3, mobility=3e-5)


@register_scenario("zhong_density", ScenarioCaps(
    species=5, rates="deterministic",
    observables=("extinction_mcs", "densities"),
    description="Zhong et al. (2022) ablated RPSLS: the Rock-crushes-"
                "Scissors edge removed; Paper goes extinct in 200-600 MCS",
    paper="paper §3.1.2, Figs 3.2/3.3 (Zhong Fig 2)"),
    dominance=lambda sc: dom_mod.zhong_ablated_rpsls())
def _build_zhong_density() -> Scenario:
    return Scenario(name="zhong_density", species=5, mobility=1e-4)


def _nspecies_dom(sc: Scenario) -> np.ndarray:
    # C(S,{1,2}) from 5 species up (RPSLS and its generalizations),
    # C(S,{1}) below: the same rule as the CLI's default network
    offs = (1, 2) if sc.species >= 5 else (1,)
    return dom_mod.circulant(sc.species, offs)


@register_scenario("nspecies", ScenarioCaps(
    species=None, rates="deterministic",
    observables=("densities", "survival"),
    description="parametric S-species cyclic game: C(S,{1,2}) for S >= 5 "
                "(RPSLS family), C(S,{1}) below; name suffix sets S "
                "('nspecies7')",
    paper="paper §3.1.1 circulant C(S,K) family"),
    dominance=_nspecies_dom)
def _build_nspecies(S: int = 5) -> Scenario:
    if S < 1:
        raise ValueError("nspecies family needs S >= 1")
    return Scenario(name=f"nspecies{S}", species=S, mobility=3e-5)


def _park_alliance_dom(sc: Scenario) -> np.ndarray:
    return dom_mod.park_alliance_network(
        sc.extra("alpha"), sc.extra("beta"), sc.extra("gamma"))


@register_scenario("probabilistic", ScenarioCaps(
    species=8, rates="probabilistic",
    observables=("survival", "survivors_hist", "extinction_mcs"),
    description="Park, Chen & Szolnoki (2023) eight-species alliances: "
                "probabilistic (alpha, beta, gamma) rates, no migration, "
                "terminate after L^2 MCS",
    paper="paper §4.3.2, Figs 4.9-4.13, Table 4.2"),
    dominance=_park_alliance_dom)
def _build_probabilistic(alpha: float = 0.15, beta: float = 0.75,
                         gamma: float = 1.0,
                         mobility: float = 0.0) -> Scenario:
    # Park et al. have no migration; mobility > 0 is the companion
    # paper's extension (epsilon then reverts to 2 * M * N)
    return Scenario(name="probabilistic", species=8, mobility=mobility,
                    epsilon=None if mobility > 0 else 0.0,
                    extras=_freeze_extras(
                        {"alpha": alpha, "beta": beta, "gamma": gamma}))


def _asym_dom(sc: Scenario) -> np.ndarray:
    r12, r23, r31 = (sc.extra("r12"), sc.extra("r23"), sc.extra("r31"))
    return dom_mod.from_dense(np.array([[0.0, r12, 0.0],
                                        [0.0, 0.0, r23],
                                        [r31, 0.0, 0.0]], dtype=np.float32))


@register_scenario("asym_rps", ScenarioCaps(
    species=3, rates="probabilistic",
    observables=("densities", "survival"),
    description="asymmetric-dominance RPS: the three cyclic edges carry "
                "unequal kill rates (r12, r23, r31) — breaks the "
                "symmetric-coexistence degeneracy",
    paper="paper §3.1.1 rate generalization (Park-style asymmetry)"),
    dominance=_asym_dom)
def _build_asym_rps(r12: float = 1.0, r23: float = 0.7,
                    r31: float = 0.4) -> Scenario:
    return Scenario(name="asym_rps", species=3, mobility=3e-5,
                    extras=_freeze_extras(
                        {"r12": r12, "r23": r23, "r31": r31}))
