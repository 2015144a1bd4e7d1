"""ScenarioServer — the in-process serving handle (port of
``repro.serve.server``, DESIGN.md §12).

One long-lived object owns the admission queue, the built-engine cache
and the scheduler loop, on the devices it was given (``device``: one
device or a list, as ``run_trials`` takes it; ``None`` every visible
card, ``"cpu"`` or ``["cpu"] * k`` the plain path):

``submit`` parses + resolves + validates a request (invalid requests get
an immediate error response — they are *answered*, never dropped),
stamps the admission time and enqueues it under its (bucket,
scenario_key) group. ``step`` drains one batch: pop a group by the
age/occupancy policy, hit or build the engine, run the packed
executor (or the single-lattice path) and materialize one
``SimResponse`` per request with per-request queue / build
(``compile_s``) / run latency. ``drain`` steps until the queue is empty. The whole object is
guarded by one reentrant lock, so the threaded HTTP adapter can share
it; execution itself is deliberately serial.

Per-chunk progress events (``progress(id)``) stream the boundary-level
state of a running request: MCS reached, trials in stasis, and — when
observables are on — that chunk's finalized observable rows.

Retention: a resident server must not grow without bound, so answered
responses (and their progress events) are retained up to
``max_responses`` — beyond that the oldest answered response is evicted
(pending requests are never touched, and ``accounting()['responded']``
counts cumulatively, so eviction never reads as a drop). Clients that
want deterministic memory bounds ``ack(id)`` responses to release them
eagerly. Latency statistics are running aggregates (count / mean / max
over the whole lifetime, percentiles over a bounded recent window), not
raw per-request lists.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

from ..core import dominance as dom_mod
from ..core import observables as obs_mod
from ..core.device import Devices, resolve_devices
from ..core.scenarios import resolve_config, scenario_key
from .bucketing import AdmissionQueue, Pending, bucket_key
from .cache import EngineCache
from .executor import (build_entry, effective_chunk, engine_kind,
                       run_packed, run_single)
from .protocol import SimRequest, SimResponse, parse_request

__all__ = ["ScenarioServer"]


class _LatencyAgg:
    """Bounded-memory latency statistics for a long-lived server: count,
    running mean and max cover the whole lifetime; percentiles come from
    the last ``window`` samples (a deque, so memory is O(window) however
    long the server runs)."""

    def __init__(self, window: int = 1024) -> None:
        self.count = 0
        self.mean = 0.0
        self.max = 0.0
        self.recent: "deque[float]" = deque(maxlen=window)

    def add(self, x: float) -> None:
        self.count += 1
        self.mean += (x - self.mean) / self.count
        self.max = max(self.max, x)
        self.recent.append(x)

    def stats(self) -> Dict[str, float]:
        if not self.count:
            return {"count": 0}
        a = np.asarray(self.recent, dtype=np.float64)
        return {"count": self.count, "mean_s": float(self.mean),
                "p50_s": float(np.percentile(a, 50)),
                "p95_s": float(np.percentile(a, 95)),
                "max_s": float(self.max)}


class ScenarioServer:
    """Continuously-batched ESCG scenario server (in-process transport).

    ``max_batch_trials`` caps the trials packed into one device batch;
    ``cache_entries`` bounds the LRU built-engine cache;
    ``max_responses`` bounds retained answered responses (oldest evicted
    first — see the module docstring's retention policy). Typical use::

        srv = ScenarioServer()           # on the card; device="cpu" too
        rid = srv.submit({"scenario": "park3", "n_trials": 4,
                          "run": {"mcs": 200, "length": 64, "height": 64}})
        srv.drain()
        resp = srv.response(rid)     # resp.result is a TrialResult
    """

    def __init__(self, max_batch_trials: int = 64,
                 cache_entries: int = 8,
                 max_responses: int = 4096,
                 device: Optional[Devices] = None) -> None:
        self.device = device
        # raises without a card unless the caller asked for the CPU
        self.devices = resolve_devices(device)
        self.max_batch_trials = int(max_batch_trials)
        self.max_responses = max(1, int(max_responses))
        self._queue = AdmissionQueue()
        self._cache = EngineCache(max_entries=int(cache_entries))
        self._lock = threading.RLock()
        self._responses: Dict[str, SimResponse] = {}
        self._events: Dict[str, List[dict]] = {}
        self._order: List[str] = []      # response ids in submit order
        self._seq = 0
        self._n_requests = 0
        self._n_responded = 0            # cumulative (survives eviction)
        self._n_errors = 0
        self._n_evicted = 0
        self._n_batches = 0
        self._n_packed_trials = 0
        self._lat_total = _LatencyAgg()
        self._lat_queue = _LatencyAgg()
        self._lat_run = _LatencyAgg()

    # ------------------------------ admission -------------------------- #

    def submit(self, request: Union[str, dict, SimRequest]) -> str:
        """Admit one request; returns its response id. Requests that fail
        parsing/resolution/validation are answered immediately with an
        error response under the same id (never silently dropped)."""
        with self._lock:
            self._seq += 1
            seq = self._seq
            self._n_requests += 1
            rid = ""
            try:
                req = parse_request(request)
                rid = req.id or f"req-{seq}"
                if rid in self._responses or any(rid == i for i in
                                                 self._order):
                    # answer under a fresh id: clobbering the original
                    # response would silently drop one of the two
                    rid = f"{rid}#dup{seq}"
                    raise ValueError(f"duplicate request id {req.id!r}")
                req = dataclasses.replace(req, id=rid)
                pend = self._admit(seq, req)
            except Exception as e:  # answered, not dropped
                rid = rid or f"req-{seq}"
                self._order.append(rid)
                self._respond(SimResponse(id=rid, ok=False, kind="error",
                                          error=str(e)))
                return rid
            self._order.append(rid)
            self._queue.push(pend)
            return rid

    def _admit(self, seq: int, req: SimRequest) -> Pending:
        if req.n_trials < 1:
            raise ValueError("n_trials must be >= 1")
        params, dom = resolve_config(req.scenario, None, req.engine,
                                     req.run)
        p = params.validate()
        if dom is None:
            dom = dom_mod.circulant(p.species)
        n_dev = len(self.devices)
        for knob, layout in (("mesh_shape", p.mesh_shape),
                             ("shard_grid", p.shard_grid)):
            if layout is not None:
                need = int(np.prod(np.asarray(layout)))
                if need > n_dev:
                    raise ValueError(
                        f"{knob} {tuple(layout)} needs {need} devices but "
                        f"this host has {n_dev}: the engine build would "
                        "fail, so the request is rejected at admission")
        kind = engine_kind(p.engine)
        if kind == "single" and req.n_trials != 1:
            raise ValueError(
                f"engine {p.engine!r} is not vmappable: the server runs "
                "it on the single-lattice path, one trial per request "
                "(submit n_trials separate requests, or pick a "
                "trial-shardable engine)")
        sched = None
        if p.observables:
            eff = effective_chunk(p, max(1, p.mcs))
            if p.obs_capacity and p.obs_capacity < eff:
                raise ValueError(
                    f"obs_capacity {p.obs_capacity} < effective chunk "
                    f"{eff}: the server's bit-identity contract forbids "
                    "lossy ring wraparound (0 = auto-size)")
            if p.k_mcs > 1 and any(
                    not s.from_counts
                    for s in obs_mod.build_pipeline(p).specs):
                # lag-held rows depend on launch-group boundaries: only
                # identical MCS schedules may share a batch (bucketing.py)
                sched = p.mcs
        return Pending(seq=seq, req=req, params=p, dom=np.asarray(dom),
                       bucket=bucket_key(p), scenario_key=scenario_key(
                           req.scenario),
                       kind=kind, n_mcs=p.mcs, sched=sched)

    # ------------------------------ scheduling ------------------------- #

    def step(self) -> int:
        """Drain ONE batch from the queue; returns the number of requests
        answered (0 when idle)."""
        with self._lock:
            popped = self._queue.pop_batch(self.max_batch_trials)
            if popped is None:
                return 0
            (bucket, skey, _sched), pends = popped
            t_start = t_run = time.perf_counter()
            first = pends[0]
            entry = None
            hit = False
            compile_s = 0.0
            try:
                # inside the try: a failed engine build (mesh infeasible
                # on this host, OOM, ...) must still ANSWER every popped
                # request — the serving contract is answered, never
                # dropped, and drain() must not raise
                entry, hit = self._cache.get_or_build(
                    (bucket, skey),
                    lambda: build_entry(first.params, first.dom,
                                        self.device))
                compile_s = 0.0 if hit else entry.build_s
                t_run = time.perf_counter()
                if entry.kind == "single":
                    results = [(pd, run_single(entry, pd, emit=self._emit))
                               for pd in pends]
                    kind = "single"
                else:
                    results = run_packed(entry, pends, emit=self._emit)
                    kind = "trials"
            except Exception as e:
                now = time.perf_counter()
                if entry is None:      # build failed: all time is the build
                    compile_s, run_s = now - t_start, 0.0
                else:
                    run_s = now - t_run
                    self._cache.note_run(entry)
                for pd in pends:
                    self._respond(SimResponse(
                        id=pd.req.id, ok=False, kind="error",
                        error=str(e),
                        timing={"queue_s": t_start - pd.t_submit,
                                "compile_s": compile_s, "run_s": run_s},
                        cache_hit=hit, bucket=bucket.short(),
                        scenario_key=skey))
                return len(pends)
            run_s = time.perf_counter() - t_run
            self._cache.note_run(entry)
            self._n_batches += 1
            self._n_packed_trials += sum(max(1, pd.req.n_trials)
                                         for pd in pends)
            for pd, res in results:
                queue_s = t_start - pd.t_submit
                self._lat_queue.add(queue_s)
                self._lat_run.add(run_s)
                self._lat_total.add(time.perf_counter() - pd.t_submit)
                self._respond(SimResponse(
                    id=pd.req.id, ok=True, kind=kind, result=res,
                    timing={"queue_s": queue_s, "compile_s": compile_s,
                            "run_s": run_s},
                    cache_hit=hit, bucket=bucket.short(),
                    scenario_key=skey))
            return len(pends)

    def drain(self) -> int:
        """Step until the queue is empty; total requests answered."""
        n = 0
        while True:
            k = self.step()
            if not k:
                return n
            n += k

    def serve(self, requests: Sequence[Union[str, dict, SimRequest]]
              ) -> List[SimResponse]:
        """Submit-all + drain convenience: responses in submit order."""
        ids = [self.submit(r) for r in requests]
        self.drain()
        out = []
        for i in ids:
            resp = self._responses.get(i)
            if resp is None:
                raise RuntimeError(
                    f"response {i!r} was evicted before collection: this "
                    f"wave exceeded max_responses={self.max_responses}; "
                    "raise it or replay in smaller waves")
            out.append(resp)
        return out

    def __call__(self, request: Union[str, dict, SimRequest]
                 ) -> SimResponse:
        """One-shot handle: submit a single request and run it now."""
        return self.serve([request])[0]

    # ------------------------------ responses -------------------------- #

    def _respond(self, resp: SimResponse) -> None:
        if not resp.ok:
            self._n_errors += 1
        self._n_responded += 1
        self._responses[resp.id] = resp
        # retention: evict the oldest ANSWERED response (and its events)
        # past max_responses; ids still pending in _order are skipped
        while len(self._responses) > self.max_responses:
            for i, rid in enumerate(self._order):
                if rid in self._responses:
                    del self._responses[rid]
                    self._events.pop(rid, None)
                    del self._order[i]
                    self._n_evicted += 1
                    break
            else:
                break

    def _emit(self, pend: Pending, event: dict) -> None:
        self._events.setdefault(pend.req.id, []).append(event)

    def response(self, rid: str) -> Optional[SimResponse]:
        with self._lock:
            return self._responses.get(rid)

    def ack(self, rid: str) -> Optional[SimResponse]:
        """Acknowledge one response: returns it (None when unknown or
        already released) and frees its retained result + events, so a
        long-lived client can bound the server's memory deterministically
        instead of waiting for LRU eviction."""
        with self._lock:
            resp = self._responses.pop(rid, None)
            if resp is not None:
                self._events.pop(rid, None)
                try:
                    self._order.remove(rid)
                except ValueError:
                    pass
            return resp

    def responses(self) -> List[SimResponse]:
        """All responses so far, in submit order."""
        with self._lock:
            return [self._responses[i] for i in self._order
                    if i in self._responses]

    def progress(self, rid: str) -> List[dict]:
        """Per-chunk streamed events for one request (empty until its
        batch starts running)."""
        with self._lock:
            return list(self._events.get(rid, ()))

    # ------------------------------ accounting ------------------------- #

    def accounting(self) -> Dict[str, Any]:
        """Serving counters: every admitted request is either pending,
        answered ok, or answered with an error — ``dropped`` (admitted
        but never answered while the queue is empty) must be zero.
        ``responded`` counts cumulatively; ``retained`` is how many
        responses are currently held (``max_responses`` bound), so
        acking or evicting a response never reads as a drop."""
        with self._lock:
            pending = len(self._queue)
            return {
                "requests": self._n_requests,
                "responded": self._n_responded,
                "errors": self._n_errors,
                "pending": pending,
                "dropped": (self._n_requests - self._n_responded
                            - pending),
                "retained": len(self._responses),
                "evicted": self._n_evicted,
                "batches": self._n_batches,
                "packed_trials": self._n_packed_trials,
                "queue_depth": self._queue.depth(),
                "cache": self._cache.accounting(),
                "latency": {
                    "total": self._lat_total.stats(),
                    "queue": self._lat_queue.stats(),
                    "run": self._lat_run.stats(),
                },
            }
