"""SimRequest / SimResponse — the serving wire protocol (port of
``repro.serve.protocol``, DESIGN.md §12). The wire format is the
reference's field for field, so one JSON request means the same to both
servers.

A request is the scenario-first driver call, reified: WHAT to simulate
(a :class:`~repro.core.scenarios.Scenario` or a registered preset name),
HOW (an :class:`~repro.core.scenarios.EngineConfig`), HOW LONG
(a :class:`~repro.core.scenarios.RunConfig`) and how many IID trials.
The server promises bit-identity: the response's result equals a direct
``run_trials(scenario, n_trials, engine=..., run=...)`` (or, for the
non-vmappable single-lattice engines, ``simulate(scenario, ...)``) call
with the same configs — whatever other traffic shared the batch.

Wire format: one JSON object per request —

``{"id": "r1", "n_trials": 2, "scenario": "park3" | {...Scenario...},
"engine": {...partial EngineConfig...}, "run": {...partial RunConfig...}}``

Partial engine/run objects carry only the overridden fields; a bare
scenario name resolves through the scenario registry (parametric
suffixes included, e.g. ``"nspecies7"``). Responses serialize the
result through the unified ``RunResult`` JSON surface
(``core/results.py``), tagged with ``kind`` so the client knows whether
to rebuild a ``TrialResult`` (``"trials"``) or ``SimResult``
(``"single"``).
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Union

from ..core.scenarios import (EngineConfig, RunConfig, Scenario,
                              make_scenario)
from ..core.simulation import SimResult
from ..core.trials import TrialResult

__all__ = [
    "SimRequest", "SimResponse", "scenario_from_wire",
    "engine_config_from_wire", "run_config_from_wire", "parse_request",
]


def scenario_from_wire(obj: Union[str, Dict[str, Any], Scenario]
                       ) -> Scenario:
    """A wire scenario — preset name, full/partial field object (an
    optional ``"name"`` routes through the registry builder so preset
    coupling like Park's mobility→epsilon rule is preserved), or an
    already-built ``Scenario``."""
    if isinstance(obj, Scenario):
        return obj.validate()
    if isinstance(obj, str):
        return make_scenario(obj)
    if not isinstance(obj, dict):
        raise ValueError(f"scenario must be a name or object, got "
                         f"{type(obj).__name__}")
    d = dict(obj)
    fields = {f.name for f in dataclasses.fields(Scenario)}
    unknown = set(d) - fields
    if unknown:
        raise ValueError(f"unknown Scenario fields {sorted(unknown)}; "
                         f"accepted: {sorted(fields)}")
    return Scenario(**d).validate()


def _tupled(d: Dict[str, Any], *keys: str) -> Dict[str, Any]:
    for k in keys:
        if d.get(k) is not None:
            d[k] = tuple(d[k])
    return d


def engine_config_from_wire(obj: Optional[Dict[str, Any]]) -> EngineConfig:
    if obj is None:
        return EngineConfig()
    if isinstance(obj, EngineConfig):
        return obj
    d = _tupled(dict(obj), "tile", "shard_grid", "mesh_shape")
    fields = {f.name for f in dataclasses.fields(EngineConfig)}
    unknown = set(d) - fields
    if unknown:
        raise ValueError(f"unknown EngineConfig fields {sorted(unknown)}")
    return EngineConfig(**d)


def run_config_from_wire(obj: Optional[Dict[str, Any]]) -> RunConfig:
    if obj is None:
        return RunConfig()
    if isinstance(obj, RunConfig):
        return obj
    d = _tupled(dict(obj), "observables")
    fields = {f.name for f in dataclasses.fields(RunConfig)}
    unknown = set(d) - fields
    if unknown:
        raise ValueError(f"unknown RunConfig fields {sorted(unknown)}")
    return RunConfig(**d)


@dataclass(frozen=True)
class SimRequest:
    """One serving request: scenario + engine + run + trial count.

    The constructor accepts the same shapes as the wire format — a preset
    name / field dict for ``scenario`` and partial dicts for
    ``engine`` / ``run`` — and normalizes them to the frozen config
    dataclasses, so in-process callers need no separate parse step."""
    scenario: Scenario
    engine: EngineConfig = field(default_factory=EngineConfig)
    run: RunConfig = field(default_factory=RunConfig)
    n_trials: int = 1
    id: str = ""

    def __post_init__(self):
        object.__setattr__(self, "scenario",
                           scenario_from_wire(self.scenario))
        object.__setattr__(self, "engine",
                           engine_config_from_wire(self.engine))
        object.__setattr__(self, "run", run_config_from_wire(self.run))

    def to_wire(self) -> Dict[str, Any]:
        return {
            "id": self.id,
            "n_trials": self.n_trials,
            "scenario": dataclasses.asdict(self.scenario),
            "engine": dataclasses.asdict(self.engine),
            "run": dataclasses.asdict(self.run),
        }

    def to_json(self) -> str:
        return json.dumps(self.to_wire())

    @staticmethod
    def from_wire(obj: Dict[str, Any]) -> "SimRequest":
        if not isinstance(obj, dict):
            raise ValueError("request must be a JSON object")
        if "scenario" not in obj:
            raise ValueError("request missing 'scenario'")
        return SimRequest(
            scenario=scenario_from_wire(obj["scenario"]),
            engine=engine_config_from_wire(obj.get("engine")),
            run=run_config_from_wire(obj.get("run")),
            n_trials=int(obj.get("n_trials", 1)),
            id=str(obj.get("id", "")),
        )

    @staticmethod
    def from_json(s: str) -> "SimRequest":
        return SimRequest.from_wire(json.loads(s))


def parse_request(obj: Union[str, Dict[str, Any], "SimRequest"]
                  ) -> "SimRequest":
    """Normalize any accepted submit payload to a ``SimRequest``."""
    if isinstance(obj, SimRequest):
        return obj
    if isinstance(obj, str):
        return SimRequest.from_json(obj)
    return SimRequest.from_wire(obj)


@dataclass
class SimResponse:
    """The server's answer for one request.

    ``kind`` selects the result type: ``"trials"`` (a ``TrialResult``
    from the packed pod-axis path), ``"single"`` (a ``SimResult`` from
    the single-lattice path for non-vmappable engines) or ``"error"``
    (``result`` is None and ``error`` carries the admission/runtime
    message). ``timing`` records per-request latency in seconds:
    ``queue_s`` (submit → batch start), ``compile_s`` (engine-cache
    build time, 0.0 on a cache hit) and ``run_s`` (the batch execution
    this request rode). ``cache_hit`` / ``bucket`` / ``scenario_key``
    expose the scheduling identity for accounting and tests."""
    id: str
    ok: bool
    kind: str                      # 'trials' | 'single' | 'error'
    result: Optional[object] = None   # TrialResult | SimResult | None
    error: str = ""
    timing: Dict[str, float] = field(default_factory=dict)
    cache_hit: bool = False
    bucket: str = ""
    scenario_key: str = ""

    def to_wire(self) -> Dict[str, Any]:
        return {
            "id": self.id,
            "ok": self.ok,
            "kind": self.kind,
            "result": (json.loads(self.result.to_json())
                       if self.result is not None else None),
            "error": self.error,
            "timing": self.timing,
            "cache_hit": self.cache_hit,
            "bucket": self.bucket,
            "scenario_key": self.scenario_key,
        }

    def to_json(self) -> str:
        return json.dumps(self.to_wire())

    @staticmethod
    def from_wire(obj: Dict[str, Any]) -> "SimResponse":
        result = None
        if obj.get("result") is not None:
            payload = json.dumps(obj["result"])
            result = (TrialResult.from_json(payload)
                      if obj.get("kind") == "trials"
                      else SimResult.from_json(payload))
        return SimResponse(
            id=str(obj.get("id", "")), ok=bool(obj.get("ok")),
            kind=str(obj.get("kind", "error")), result=result,
            error=str(obj.get("error", "")),
            timing=dict(obj.get("timing", {})),
            cache_hit=bool(obj.get("cache_hit")),
            bucket=str(obj.get("bucket", "")),
            scenario_key=str(obj.get("scenario_key", "")),
        )

    @staticmethod
    def from_json(s: str) -> "SimResponse":
        return SimResponse.from_wire(json.loads(s))
