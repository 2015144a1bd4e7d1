"""Trace-driven load generation (port of ``repro.serve.loadgen``,
DESIGN.md §12).

A *trace* is a JSONL file, one ``SimRequest`` wire object per line — the
committed smoke trace lives at ``examples/traces/smoke.jsonl``.
``replay`` submits a trace against a :class:`ScenarioServer` in *waves*
(each wave re-submits the whole trace under fresh ids, draining between
waves): within a wave same-bucket requests pack into shared batches,
across waves every bucket re-forms and must HIT the built-engine cache —
the replay is at once a throughput measurement and a cache-behaviour
check.

The emitted report (``escg-serve-report/v1``) carries request and
lattice-update throughput, the per-request latency profile and the full
serving accounting and the backend the server ran on (``cuda`` on the
card, ``cpu``); ``gate_row`` reshapes it into a ``bench_gate``
family-``serve`` row.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Dict, Iterable, List, Sequence, Union

from .protocol import SimRequest, parse_request
from .server import ScenarioServer

__all__ = ["synthetic_trace", "read_trace", "write_trace", "replay",
           "check_report", "gate_row", "REPORT_SCHEMA"]

REPORT_SCHEMA = "escg-serve-report/v1"

# deterministic smoke mix: 3 scenarios x 2 lattice extents over 5
# bucket-distinct combos — any n >= 10 revisits every bucket at least
# twice per wave, so the admission queue actually packs
_COMBOS = (
    ("park3", "batched", (16, 16), 6, 2),
    ("zhong_density", "batched", (16, 16), 6, 1),
    ("nspecies5", "sublattice", (16, 16), 12, 2),
    ("park3", "batched", (32, 16), 12, 1),
    ("zhong_density", "sublattice", (32, 16), 6, 2),
)


def synthetic_trace(n: int = 10, seed: int = 0) -> List[Dict[str, Any]]:
    """``n`` wire-format requests cycling the smoke combo mix with
    distinct seeds (byte-stable for a given ``(n, seed)``)."""
    reqs = []
    for i in range(n):
        scenario, engine, (h, ln), mcs, trials = _COMBOS[i % len(_COMBOS)]
        reqs.append({
            "id": f"r{i + 1}",
            "n_trials": trials,
            "scenario": scenario,
            "engine": {"engine": engine, "tile": [8, 8]},
            "run": {"height": h, "length": ln, "mcs": mcs,
                    "chunk_mcs": 6, "seed": seed + i},
        })
    return reqs


def read_trace(path: str) -> List[Dict[str, Any]]:
    reqs = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                reqs.append(json.loads(line))
    return reqs


def write_trace(path: str, reqs: Iterable[Union[dict, SimRequest]]) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for r in reqs:
            wire = r.to_wire() if isinstance(r, SimRequest) else r
            f.write(json.dumps(wire) + "\n")


def replay(server: ScenarioServer,
           requests: Sequence[Union[dict, str, SimRequest]],
           waves: int = 2) -> Dict[str, Any]:
    """Replay ``requests`` through ``server`` ``waves`` times and report.

    Within a wave, all requests are submitted before the drain, so
    same-bucket traffic packs; each later wave re-encounters every
    (bucket, scenario) pair and exercises the cache-hit path."""
    parsed = [parse_request(r) for r in requests]
    ids: List[str] = []
    t0 = time.perf_counter()
    for w in range(max(1, waves)):
        for i, req in enumerate(parsed):
            base = req.id or f"req{i + 1}"
            rid = base if waves <= 1 else f"{base}-w{w + 1}"
            ids.append(server.submit(dataclasses.replace(req, id=rid)))
        server.drain()
    wall_s = time.perf_counter() - t0

    n_ok = n_error = 0
    updates = 0
    for w in range(max(1, waves)):
        for i, req in enumerate(parsed):
            resp = server.response(ids[w * len(parsed) + i])
            if resp is None or not resp.ok:
                n_error += 1
                continue
            n_ok += 1
            res = resp.result
            n_cells = req.run.height * req.run.length
            n_trials = getattr(res, "n_trials", 1)
            updates += int(res.mcs_completed) * n_cells * n_trials

    acct = server.accounting()
    return {
        "schema": REPORT_SCHEMA,
        "n_requests": len(ids),
        "n_ok": n_ok,
        "n_error": n_error,
        "dropped": acct["dropped"],
        "waves": max(1, waves),
        "wall_s": wall_s,
        "requests_per_s": len(ids) / wall_s if wall_s else 0.0,
        "updates": updates,
        "updates_per_s": updates / wall_s if wall_s else 0.0,
        "backend": server.devices[0].type,
        "latency": acct["latency"],
        "cache": acct["cache"],
        "accounting": acct,
    }


def check_report(report: Dict[str, Any]) -> List[str]:
    """Acceptance checks for a replay report; empty list = pass.

    * every admitted request was answered (zero dropped),
    * no request errored,
    * repeat traffic hit the built-engine cache at least once."""
    problems = []
    if report.get("schema") != REPORT_SCHEMA:
        problems.append(f"schema {report.get('schema')!r} != "
                        f"{REPORT_SCHEMA!r}")
    if report.get("dropped", -1) != 0:
        problems.append(f"dropped={report.get('dropped')} (want 0)")
    if report.get("n_error", -1) != 0:
        problems.append(f"n_error={report.get('n_error')} (want 0)")
    cache = report.get("cache", {})
    if cache.get("hits", 0) < 1:
        problems.append(f"cache hits={cache.get('hits')} (want >= 1: "
                        "repeated buckets must not build again)")
    return problems


def gate_row(report: Dict[str, Any]) -> Dict[str, Any]:
    """A bench_gate family-``serve`` row derived from a replay report;
    ``backend`` is where the server ran (``cuda`` on the card)."""
    rps = report["requests_per_s"]
    mups = report["updates_per_s"] / 1e6
    return {
        "name": "serve_throughput_smoke",
        "family": "serve",
        "scenario": "mixed",
        "local_kernel": "mixed",
        "engine": "server",
        "backend": report["backend"],
        "observables": False,
        "us_per_call": (report["wall_s"] / report["n_requests"] * 1e6
                        if report["n_requests"] else 0.0),
        "derived": f"{rps:.2f} req/s, {mups:.3f} Mupd/s",
        "n_requests": report["n_requests"],
        "requests_per_s": rps,
        "updates_per_s": report["updates_per_s"],
        "cache_hits": report["cache"].get("hits", 0),
        "cache_misses": report["cache"].get("misses", 0),
        "dropped": report["dropped"],
    }
