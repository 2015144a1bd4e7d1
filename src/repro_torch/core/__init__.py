"""Lattice, rules, PRNG, engines, scenarios and the MCS loop of the port:
the same public surface as ``repro.core``, on PyTorch."""
from . import batched, dominance, engines, io, lattice, metrics, observables
from . import park, reference, results, rng, rules, scenarios, simulation
from . import sublattice, trials
from .engines import BuiltEngine, EngineCaps, EngineSpec, engine_names
from .engines import engine_specs, get_engine, register
from .params import EscgParams
from .results import RunResult
from .scenarios import (EngineConfig, RunConfig, Scenario, ScenarioCaps,
                        ScenarioSpec, compose, decompose, get_scenario,
                        make_scenario, register_scenario, scenario_names,
                        scenario_specs)
from .simulation import SimResult, run_trials, simulate
from .trials import TrialResult


def __getattr__(name: str):
    # ``ENGINES`` read from the registry at each access (as
    # ``params.ENGINES``): an import here would freeze the list
    if name == "ENGINES":
        return engine_names()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "EscgParams", "ENGINES", "SimResult", "simulate", "run_trials",
    "TrialResult", "RunResult",
    "BuiltEngine", "EngineCaps", "EngineSpec", "engine_names",
    "engine_specs", "get_engine", "register",
    "Scenario", "ScenarioCaps", "ScenarioSpec", "EngineConfig", "RunConfig",
    "register_scenario", "scenario_names", "scenario_specs", "get_scenario",
    "make_scenario", "compose", "decompose",
    "batched", "dominance", "engines", "io", "lattice", "metrics",
    "observables", "park", "reference", "results", "rng", "rules",
    "scenarios", "simulation", "sublattice", "trials",
]
