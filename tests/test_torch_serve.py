"""The port's scenario server (``repro_torch.serve``, ``launch/serve.py``)
on the CPU: the behaviour tests of the reference's ``tests/test_serve.py``
(protocol, bucketing, the engine cache, admission rails, early exit,
progress events, duplicate ids, retention, the HTTP adapter, loadgen's
trace and report, the committed smoke trace), and the port's responses
held to the JAX server's on the same requests.

The reference's retrace checks read jit cache sizes; the port traces
nothing, so they become checks that a repeat bucket builds no engine
(``engines.BUILDS``). The JAX servers run under
``jax.threefry_partitionable(False)``: in this process for ``batched``,
``sublattice`` and ``pallas_fused`` (its Pallas kernels through their
plain reference, as in ``tests/test_torch_cli.py``), and in one
subprocess with 8 fake devices for ``sharded`` (the port on
``["cpu"] * 4``) and ``sharded_pod`` (on ``["cpu"] * 8``).
"""
import json
import os
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from repro_torch.core import engines
from repro_torch.core.scenarios import (EngineConfig, RunConfig,
                                        make_scenario, resolve_config)
from repro_torch.core.simulation import simulate
from repro_torch.core.trials import run_trials
from repro_torch.serve import ScenarioServer, SimRequest, loadgen
from repro_torch.serve.bucketing import AdmissionQueue, BucketKey, Pending, \
    bucket_key
from repro_torch.serve.cache import BuiltEntry, EngineCache
from repro_torch.serve.protocol import SimResponse, parse_request

from test_torch_cli import jax_plain_fused  # noqa: F401  (a fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENGINE = {"engine": "batched", "tile": [8, 8]}
RUN16 = {"height": 16, "length": 16, "mcs": 10, "chunk_mcs": 5}


def req16(seed=0, mcs=10, n_trials=2, scenario="park3", rid="",
          observables=None, engine=ENGINE):
    run = dict(RUN16, seed=seed, mcs=mcs)
    if observables is not None:
        run["observables"] = observables
    return SimRequest(scenario, engine=engine, run=run,
                      n_trials=n_trials, id=rid)


def direct_trials(req, device="cpu"):
    """The ground truth the server must reproduce bit for bit."""
    return run_trials(req.scenario, n_trials=req.n_trials,
                      engine=req.engine, run=req.run, device=device)


def assert_trial_results_equal(a, b):
    np.testing.assert_array_equal(a.survival, b.survival)
    np.testing.assert_array_equal(a.densities, b.densities)
    np.testing.assert_array_equal(a.stasis_mcs, b.stasis_mcs)
    np.testing.assert_array_equal(a.extinction_mcs, b.extinction_mcs)
    assert a.mcs_completed == b.mcs_completed
    assert a.kept_fraction == b.kept_fraction
    assert a.n_trials == b.n_trials
    assert set(a.observables) == set(b.observables)
    for k in a.observables:
        np.testing.assert_array_equal(a.observables[k], b.observables[k])


@pytest.fixture(scope="module")
def server():
    """One server shared by the module."""
    return ScenarioServer(max_batch_trials=64, cache_entries=8,
                          device="cpu")


# ------------------------------ protocol ----------------------------------- #

class TestProtocol:
    def test_request_constructor_normalizes_wire_shapes(self):
        r = req16(seed=3)
        assert r.scenario.name == "park3"
        assert r.engine.engine == "batched" and r.engine.tile == (8, 8)
        assert r.run.seed == 3 and r.run.chunk_mcs == 5

    def test_request_json_roundtrip(self):
        r = req16(seed=7, n_trials=3, rid="a1")
        assert SimRequest.from_json(r.to_json()) == r

    def test_wire_format_is_the_references(self):
        from repro.serve.protocol import SimRequest as JaxRequest
        r = req16(seed=7, n_trials=3, rid="a1", observables=("densities",))
        assert json.loads(JaxRequest.from_json(r.to_json()).to_json()) == \
            json.loads(r.to_json())

    def test_unknown_fields_rejected(self):
        with pytest.raises(ValueError, match="unknown Scenario"):
            parse_request({"scenario": {"name": "x", "speces": 3}})
        with pytest.raises(ValueError, match="unknown EngineConfig"):
            parse_request({"scenario": "park3", "engine": {"engin": "b"}})
        with pytest.raises(ValueError, match="unknown RunConfig"):
            parse_request({"scenario": "park3", "run": {"mc": 5}})
        with pytest.raises(ValueError, match="missing 'scenario'"):
            parse_request({"n_trials": 2})

    def test_response_json_roundtrip_trials(self, server):
        resp = server(req16(seed=11, rid="rt1"))
        assert resp.ok and resp.kind == "trials"
        back = SimResponse.from_json(resp.to_json())
        assert back.id == "rt1" and back.ok and back.kind == "trials"
        assert back.cache_hit == resp.cache_hit
        assert back.bucket == resp.bucket
        assert back.scenario_key == resp.scenario_key
        assert_trial_results_equal(back.result, resp.result)

    def test_error_response_roundtrip(self, server):
        resp = server({"scenario": "no_such_preset", "id": "bad1"})
        assert not resp.ok and resp.kind == "error" and resp.error
        back = SimResponse.from_json(resp.to_json())
        assert back.kind == "error" and back.result is None
        assert back.error == resp.error


# ------------------------------ bucketing ---------------------------------- #

def _resolved(seed=0, mcs=10, scenario="park3", **over):
    r = req16(seed=seed, mcs=mcs, scenario=scenario)
    engine = r.engine.replace(**over) if over else r.engine
    p, _ = resolve_config(r.scenario, None, engine, r.run)
    return p.validate()


A_KEY = BucketKey("batched", "jnp", 1, (8, 8), 16, 16, 3, "int32",
                  None, None, 5, (), 0)


class TestBucketing:
    def test_seed_mcs_trials_do_not_move_the_bucket(self):
        assert bucket_key(_resolved(seed=1, mcs=10)) == \
            bucket_key(_resolved(seed=9, mcs=20))

    def test_shape_knobs_move_the_bucket(self):
        b = bucket_key(_resolved())
        assert bucket_key(_resolved(tile=(4, 4))) != b
        assert bucket_key(_resolved(engine="sublattice")) != b

    def test_short_is_human_readable_and_the_references(self):
        from repro.serve.bucketing import BucketKey as JaxKey
        s = bucket_key(_resolved()).short()
        assert "batched" in s and "16x16" in s
        assert JaxKey(*bucket_key(_resolved())).short() == s

    def _pend(self, seq, bucket, n_trials=1, skey="k"):
        return Pending(seq=seq, req=req16(n_trials=n_trials),
                       params=None, dom=np.zeros((4, 4)), bucket=bucket,
                       scenario_key=skey, kind="vmap", n_mcs=10)

    def test_pop_batch_age_policy(self):
        b = A_KEY._replace(height=32)
        q = AdmissionQueue()
        q.push(self._pend(1, A_KEY))
        q.push(self._pend(2, b))
        q.push(self._pend(3, A_KEY))
        gkey, take = q.pop_batch(64)       # a holds the oldest request
        assert gkey[0] == A_KEY and [p.seq for p in take] == [1, 3]
        gkey, take = q.pop_batch(64)
        assert gkey[0] == b and len(q) == 0
        assert q.pop_batch(64) is None

    def test_pop_batch_occupancy_beats_age(self):
        b = A_KEY._replace(height=32)
        q = AdmissionQueue()
        q.push(self._pend(1, A_KEY))                   # oldest
        q.push(self._pend(2, b, n_trials=64))          # full batch
        gkey, _ = q.pop_batch(64)
        assert gkey[0] == b                            # occupancy wins
        gkey, _ = q.pop_batch(64)
        assert gkey[0] == A_KEY

    def test_pop_batch_respects_trial_cap_but_never_starves(self):
        q = AdmissionQueue()
        q.push(self._pend(1, A_KEY, n_trials=6))
        q.push(self._pend(2, A_KEY, n_trials=6))
        _, take = q.pop_batch(8)           # 6 fits, 6+6 does not
        assert [p.seq for p in take] == [1]
        _, take = q.pop_batch(4)           # over-cap request still runs
        assert [p.seq for p in take] == [2]

    def test_depth_keys_distinct_per_group(self):
        q = AdmissionQueue()
        p1 = self._pend(1, A_KEY, n_trials=2, skey="deadbeef" + "0" * 56)
        p2 = self._pend(2, A_KEY, n_trials=3, skey="deadbeef" + "0" * 56)
        p2.sched = 10
        p3 = self._pend(3, A_KEY, n_trials=1, skey="deadbeef" + "f" * 56)
        for p in (p1, p2, p3):
            q.push(p)
        depth = q.depth()
        assert len(depth) == 3              # sched + full hash both kept
        assert sorted(depth.values()) == [1, 2, 3]


# ------------------------------ cache -------------------------------------- #

class TestEngineCache:
    def _entry(self):
        return BuiltEntry(key=None, params=None, dom=np.zeros(1),
                          kind="vmap")

    def test_hit_miss_lru_eviction(self):
        c = EngineCache(max_entries=2)
        e1, hit = c.get_or_build("k1", self._entry)
        assert not hit and e1.key == "k1"
        _, hit = c.get_or_build("k1", self._entry)
        assert hit
        c.get_or_build("k2", self._entry)
        c.get_or_build("k1", self._entry)  # refresh k1 to MRU
        c.get_or_build("k3", self._entry)  # evicts k2 (LRU)
        assert "k2" not in c and "k1" in c and "k3" in c
        assert c.accounting() == {
            "entries": 2, "max_entries": 2, "hits": 2, "misses": 3,
            "evictions": 1, "retraces": 0, "length_traces": 0,
            "hit_rate": 2 / 5}

    def test_a_build_during_a_warm_batch_counts(self, monkeypatch):
        """The first batch after a miss may build (it is the build);
        a warm entry's batch that builds an engine is counted, and
        builds between two batches of another entry are not."""
        c = EngineCache()
        e, _ = c.get_or_build("k", self._entry)
        monkeypatch.setattr(engines, "BUILDS", engines.BUILDS + 1)
        c.note_run(e)          # first batch: no retrace
        assert c.retraces == 0
        c.get_or_build("k", self._entry)
        c.note_run(e)          # warm, nothing built
        assert c.retraces == 0
        monkeypatch.setattr(engines, "BUILDS", engines.BUILDS + 1)
        c.get_or_build("k", self._entry)   # built before the batch: not it
        c.note_run(e)
        assert c.retraces == 0
        c.get_or_build("k", self._entry)
        monkeypatch.setattr(engines, "BUILDS", engines.BUILDS + 1)
        c.note_run(e)          # built during a warm batch: counted
        assert c.retraces == 1

    def test_a_per_request_build_on_a_hit_counts_a_retrace(self,
                                                           monkeypatch):
        """The regression ``retraces`` guards against: an executor path
        that builds an engine per request instead of using the entry's."""
        from repro_torch.serve import server as server_mod
        real = server_mod.run_packed

        def rebuilding(entry, pends, emit=None):
            engines.build(entry.params, entry.dom, "cpu")
            return real(entry, pends, emit=emit)

        monkeypatch.setattr(server_mod, "run_packed", rebuilding)
        srv = ScenarioServer(device="cpu")
        assert srv(req16(seed=11, rid="rb-a")).ok
        assert srv.accounting()["cache"]["retraces"] == 0   # the miss
        assert srv(req16(seed=12, rid="rb-b")).ok
        cache = srv.accounting()["cache"]
        assert cache["hits"] == 1 and cache["retraces"] == 1, cache


# ------------------------------ server ------------------------------------- #

class TestServer:
    def test_packed_batch_bit_identical_to_direct_runs(self, server):
        """Three same-bucket requests with different seeds and MCS
        budgets (3 stops inside the first chunk of 5) share one batch;
        each equals its own direct ``run_trials`` (observables included:
        park3 streams densities and interface_length by default)."""
        reqs = [req16(seed=3, mcs=10, rid="pk-a"),
                req16(seed=9, mcs=20, rid="pk-b"),
                req16(seed=5, mcs=3, n_trials=1, rid="pk-c")]
        before = server.accounting()["batches"]
        resps = server.serve(reqs)
        assert [r.ok for r in resps] == [True, True, True]
        assert server.accounting()["batches"] == before + 1
        assert len({r.bucket for r in resps}) == 1
        assert len({r.scenario_key for r in resps}) == 1
        for req, resp in zip(reqs, resps):
            assert_trial_results_equal(resp.result, direct_trials(req))

    def test_early_exit_parity(self, server):
        r = SimRequest("park3", engine=ENGINE,
                       run={"height": 8, "length": 8, "mcs": 200,
                            "chunk_mcs": 10, "seed": 5,
                            "observables": ()},
                       n_trials=2, id="early")
        resp = server(r)
        assert resp.ok
        assert_trial_results_equal(resp.result, direct_trials(r))
        assert resp.result.mcs_completed < 200

    def test_cache_hit_builds_no_engine_on_repeat_bucket(self, server):
        """Same bucket, new seeds/budgets, separate drains: the second
        batch hits the cache and builds no engine."""
        b0 = engines.BUILDS
        r1 = server(req16(seed=21, mcs=10, rid="nr-a",
                          scenario="nspecies4"))
        b1 = engines.BUILDS
        c1 = server.accounting()["cache"]
        r2 = server(req16(seed=22, mcs=20, rid="nr-b",
                          scenario="nspecies4"))
        c2 = server.accounting()["cache"]
        assert r1.ok and r2.ok
        assert not r1.cache_hit and b1 == b0 + 1   # the miss built one
        assert r2.cache_hit and engines.BUILDS == b1
        assert c2["hits"] == c1["hits"] + 1
        assert c2["misses"] == c1["misses"]
        assert r1.timing["compile_s"] > 0.0
        assert r2.timing["compile_s"] == 0.0

    def test_mixed_buckets_in_one_drain_pack_per_group(self, server):
        reqs = [
            req16(seed=31, rid="mx1"),
            req16(seed=32, mcs=20, rid="mx2"),
            req16(seed=33, scenario="zhong_density", rid="mx3"),
            req16(seed=34, scenario="zhong_density", rid="mx4"),
            SimRequest("nspecies5", engine=ENGINE,
                       run=dict(RUN16, seed=35, height=32), n_trials=1,
                       id="mx5"),
            SimRequest("nspecies5", engine=ENGINE,
                       run=dict(RUN16, seed=36, height=32), n_trials=2,
                       id="mx6"),
        ]
        before = server.accounting()["batches"]
        resps = server.serve(reqs)
        assert all(r.ok for r in resps)
        assert server.accounting()["batches"] == before + 3
        for req, resp in zip(reqs, resps):
            assert_trial_results_equal(resp.result, direct_trials(req))
        assert server.accounting()["dropped"] == 0

    def test_single_lattice_path_matches_simulate(self, server):
        sc = make_scenario("park3")
        ec = EngineConfig(engine="sharded", shard_grid=(1, 1), tile=(8, 8))
        rc = RunConfig(height=16, length=16, mcs=10, chunk_mcs=5, seed=4,
                       observables=())
        resp = server(SimRequest(sc, engine=ec, run=rc, id="sg1"))
        assert resp.ok and resp.kind == "single"
        ref = simulate(sc, engine=ec, run=rc, device="cpu")
        np.testing.assert_array_equal(resp.result.grid, ref.grid)
        np.testing.assert_array_equal(resp.result.densities, ref.densities)
        assert resp.result.mcs_completed == ref.mcs_completed
        assert resp.result.stasis_mcs == ref.stasis_mcs
        assert resp.result.kept_fraction == ref.kept_fraction

    def test_progress_events_stream_chunk_boundaries(self, server):
        rid = server.submit(req16(seed=41, mcs=20, rid="prog1"))
        assert server.progress(rid) == []       # nothing ran yet
        server.drain()
        events = server.progress(rid)
        assert [e["mcs"] for e in events] == [5, 10, 15, 20]
        assert all(e["n_trials"] == 2 for e in events)
        assert events[-1]["done"] and not events[0]["done"]
        assert "observables" in events[-1]      # park3 streams by default

    def test_admission_rails_answer_never_drop(self, server):
        errs = server.serve([
            {"scenario": "park3", "n_trials": 0, "id": "e-zero"},
            {"scenario": "park3", "n_trials": 2, "id": "e-single",
             "engine": {"engine": "sharded", "shard_grid": [1, 1],
                        "tile": [8, 8]},
             "run": RUN16},
            {"scenario": "park3", "n_trials": 1, "id": "e-ring",
             "engine": ENGINE,
             "run": dict(RUN16, obs_capacity=2)},
        ])
        assert [e.ok for e in errs] == [False, False, False]
        assert "n_trials" in errs[0].error
        assert "not vmappable" in errs[1].error
        assert "obs_capacity" in errs[2].error
        assert server.accounting()["dropped"] == 0

    def test_mixed_budget_repeat_traffic_builds_nothing(self):
        """A repeat bucket can run a chunk length its entry has not run
        (mcs=6 then mcs=4 under chunk 5): no engine is built, and the
        results equal the direct runs."""
        srv = ScenarioServer(device="cpu")
        run = dict(RUN16, chunk_mcs=5)
        ra = SimRequest("park3", engine=ENGINE,
                        run=dict(run, seed=91, mcs=6), n_trials=2,
                        id="mb-a")
        rb = SimRequest("park3", engine=ENGINE,
                        run=dict(run, seed=92, mcs=4), n_trials=2,
                        id="mb-b")
        resp_a = srv(ra)
        builds = engines.BUILDS
        resp_b = srv(rb)
        assert resp_a.ok and resp_b.ok
        cache = srv.accounting()["cache"]
        assert cache["hits"] == 1 and cache["misses"] == 1, cache
        assert engines.BUILDS == builds
        assert resp_b.cache_hit and resp_b.timing["compile_s"] == 0.0
        assert_trial_results_equal(resp_a.result, direct_trials(ra))
        assert_trial_results_equal(resp_b.result, direct_trials(rb))

    def test_engine_build_failure_answers_every_request(self,
                                                        monkeypatch):
        from repro_torch.serve import server as server_mod
        srv = ScenarioServer(device="cpu")

        def boom(params, dom, device=None):
            raise RuntimeError("engine build exploded")

        monkeypatch.setattr(server_mod, "build_entry", boom)
        ids = [srv.submit(req16(seed=95, rid="bf-a")),
               srv.submit(req16(seed=96, rid="bf-b"))]
        assert srv.drain() == 2                     # no exception
        for rid in ids:
            resp = srv.response(rid)
            assert resp is not None and not resp.ok
            assert "engine build exploded" in resp.error
            assert resp.timing["compile_s"] >= 0.0
        acct = srv.accounting()
        assert acct["dropped"] == 0 and acct["errors"] == 2

    def test_infeasible_mesh_rejected_at_admission(self):
        """A layout that needs more devices than the server has is
        answered at admission: ``["cpu"] * 4`` cannot hold (2, 2, 2)."""
        srv = ScenarioServer(device=["cpu"] * 4)
        resp = srv({"scenario": "park3", "n_trials": 1, "id": "mesh1",
                    "engine": {"engine": "sharded_pod",
                               "mesh_shape": [2, 2, 2], "tile": [8, 8]},
                    "run": RUN16})
        assert not resp.ok and "needs 8 devices" in resp.error
        assert srv.accounting()["dropped"] == 0

    def test_response_retention_bounded_and_ack(self):
        srv = ScenarioServer(max_responses=2, device="cpu")
        ids = [srv.submit(req16(seed=86 + i, rid=f"ret-{i}"))
               for i in range(3)]
        srv.drain()
        acct = srv.accounting()
        assert acct["responded"] == 3 and acct["dropped"] == 0
        assert acct["retained"] == 2 and acct["evicted"] == 1
        assert srv.response(ids[0]) is None          # oldest evicted
        assert srv.progress(ids[0]) == []            # events went with it
        assert srv.response(ids[1]).ok
        acked = srv.ack(ids[1])
        assert acked is not None and acked.ok
        assert srv.ack(ids[1]) is None               # already released
        assert srv.accounting()["retained"] == 1
        assert srv.accounting()["dropped"] == 0      # acks never drop

    def test_duplicate_id_answered_without_clobbering_original(self,
                                                               server):
        r1 = server(req16(seed=51, rid="dup"))
        assert r1.ok
        rid = server.submit(req16(seed=52, rid="dup"))
        assert rid != "dup"                      # answered under a fresh id
        resp = server.response(rid)
        assert resp is not None and not resp.ok
        assert "duplicate" in resp.error
        assert server.response("dup").ok         # original intact

    def test_responses_in_submit_order_and_accounting_consistent(self,
                                                                 server):
        server(req16(seed=53, rid="ord"))
        acct = server.accounting()
        assert acct["requests"] == acct["responded"] + acct["pending"]
        assert acct["dropped"] == 0
        assert acct["latency"]["total"]["count"] >= 1
        assert 0.0 < acct["cache"]["hit_rate"] <= 1.0
        ids = [r.id for r in server.responses()]
        assert ids == [i for i in server._order if i in server._responses]

    def test_server_needs_a_card_unless_given_the_cpu(self):
        import torch
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default is valid here")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ScenarioServer()


def test_run_built_serves_many_requests_from_one_build():
    """``run_built`` over one built engine and chunk, with another seed
    and budget per call, equals ``simulate`` of each and builds nothing;
    ``on_chunk`` sees every chunk boundary and the stasis MCS."""
    from repro_torch.core.simulation import build_chunk_fn, run_built
    sc = make_scenario("park3")
    ec = EngineConfig(engine="sublattice", tile=(8, 8))
    p0, dom = resolve_config(sc, None, ec, RunConfig(
        height=16, length=16, mcs=10, chunk_mcs=4, observables=()))
    p0 = p0.validate()
    built = engines.build(p0, dom, "cpu")
    chunk = build_chunk_fn(p0, built)
    for seed, mcs in ((4, 10), (5, 3), (6, 9)):
        rc = RunConfig(height=16, length=16, mcs=mcs, chunk_mcs=4,
                       seed=seed, observables=())
        p, _ = resolve_config(sc, None, ec, rc)
        seen = []
        builds = engines.BUILDS
        res = run_built(p.validate(), built, chunk,
                        on_chunk=lambda m, st: seen.append((m, st)))
        assert engines.BUILDS == builds
        ref = simulate(sc, engine=ec, run=rc, device="cpu")
        np.testing.assert_array_equal(res.grid, ref.grid)
        np.testing.assert_array_equal(res.densities, ref.densities)
        assert res.mcs_completed == ref.mcs_completed
        assert res.kept_fraction == ref.kept_fraction
        assert [m for m, _ in seen] == list(range(
            4, ref.mcs_completed, 4)) + [ref.mcs_completed]
        assert seen[-1][1] == ref.stasis_mcs


# ------------------------------ http adapter ------------------------------- #

def test_http_adapter_roundtrip(server):
    from repro_torch.serve.httpd import serve_http
    httpd, _ = serve_http(server, port=0, background=True)
    try:
        base = "http://127.0.0.1:%d" % httpd.server_address[1]

        def post(path, payload=None):
            data = json.dumps(payload).encode() if payload is not None \
                else b""
            r = urllib.request.Request(base + path, data=data,
                                       method="POST")
            with urllib.request.urlopen(r) as f:
                return json.loads(f.read())

        def get(path):
            with urllib.request.urlopen(base + path) as f:
                return json.loads(f.read())

        assert get("/healthz") == {"ok": True}
        wire = req16(seed=61, rid="http1").to_wire()
        assert post("/submit", wire) == {"ids": ["http1"]}
        assert post("/drain")["answered"] >= 1
        resp = get("/response?id=http1")
        assert resp["ok"] and resp["kind"] == "trials"
        assert resp["result"]["n_trials"] == 2
        assert get("/progress?id=http1")["events"]
        assert get("/accounting")["dropped"] == 0
        assert post("/ack?id=http1")["ok"]       # released, still a reply
        with pytest.raises(urllib.error.HTTPError):
            get("/response?id=http1")            # 404 once acked
        assert get("/accounting")["dropped"] == 0
    finally:
        httpd.shutdown()
        httpd.server_close()


# ------------------------------ loadgen ------------------------------------ #

class TestLoadgen:
    def test_synthetic_trace_is_the_references(self):
        from repro.serve import loadgen as jloadgen
        a = loadgen.synthetic_trace(10, 0)
        assert a == loadgen.synthetic_trace(10, 0) and len(a) == 10
        assert a == jloadgen.synthetic_trace(10, 0)
        assert len({r["scenario"] for r in a}) >= 3
        assert len({(r["run"]["height"], r["run"]["length"])
                    for r in a}) >= 2
        assert loadgen.synthetic_trace(10, 1) != a   # seed moves seeds

    def test_trace_file_roundtrip(self, tmp_path):
        path = str(tmp_path / "t.jsonl")
        reqs = loadgen.synthetic_trace(4, 2)
        loadgen.write_trace(path, reqs)
        with open(path) as f:
            assert len(f.read().strip().splitlines()) == 4
        assert loadgen.read_trace(path) == reqs

    def test_replay_report_and_gate_row(self, server):
        reqs = [req16(seed=71, rid="lg1").to_wire(),
                req16(seed=72, mcs=20, rid="lg2").to_wire()]
        c0 = server.accounting()["cache"]
        report = loadgen.replay(server, reqs, waves=2)
        assert report["schema"] == loadgen.REPORT_SCHEMA
        assert report["n_requests"] == 4 and report["n_ok"] == 4
        assert report["dropped"] == 0 and report["backend"] == "cpu"
        assert report["updates"] > 0 and report["updates_per_s"] > 0
        assert report["cache"]["hits"] >= c0["hits"] + 1
        assert loadgen.check_report(report) == []
        row = loadgen.gate_row(report)
        assert row["family"] == "serve" and row["dropped"] == 0
        assert row["backend"] == "cpu"
        assert row["requests_per_s"] > 0 and row["us_per_call"] > 0
        from benchmarks import bench_gate as bg
        assert bg.validate_gate_row(row) == []

    def test_check_report_flags_problems(self):
        bad = {"schema": "nope", "dropped": 1, "n_error": 2,
               "cache": {"hits": 0}}
        problems = loadgen.check_report(bad)
        assert len(problems) == 4
        joined = " ".join(problems)
        assert "schema" in joined and "dropped=1" in joined
        assert "n_error=2" in joined and "hits=0" in joined


def test_committed_smoke_trace_is_mixed_and_packs():
    reqs = loadgen.read_trace(
        os.path.join(REPO, "examples", "traces", "smoke.jsonl"))
    assert len(reqs) == 10
    assert len({r["scenario"] for r in reqs}) >= 3
    assert len({(r["run"]["height"], r["run"]["length"])
                for r in reqs}) >= 2
    srv = ScenarioServer(device="cpu")
    groups = {}
    for i, r in enumerate(reqs):
        pend = srv._admit(i + 1, parse_request(r))
        groups.setdefault(pend.group, []).append(pend)
    assert len(groups) >= 4
    assert all(len(v) >= 2 for v in groups.values()), {
        k[0].short(): len(v) for k, v in groups.items()}


# ------------------------------ CLI ---------------------------------------- #

class TestCli:
    def test_emit_trace_roundtrip(self, tmp_path):
        from repro_torch.launch.serve import main
        path = str(tmp_path / "trace.jsonl")
        assert main(["--emitTrace", path, "--synthetic", "4"]) == 0
        assert loadgen.read_trace(path) == loadgen.synthetic_trace(4, 0)

    def test_replay_check_and_report(self, tmp_path, capsys):
        from repro_torch.launch.serve import main
        trace = str(tmp_path / "t.jsonl")
        report = str(tmp_path / "report.json")
        loadgen.write_trace(trace, [req16(seed=81, rid="c1").to_wire(),
                                    req16(seed=82, rid="c2").to_wire()])
        rc = main(["--trace", trace, "--waves", "2", "--report", report,
                   "--check", "--device", "cpu"])
        captured = capsys.readouterr()
        assert rc == 0, captured.err
        with open(report) as f:
            rep = json.load(f)
        assert rep["schema"] == loadgen.REPORT_SCHEMA
        assert rep["n_requests"] == 4 and rep["cache"]["hits"] >= 1
        assert rep["cache"]["misses"] == 1
        assert "req/s" in captured.out

    def test_smoke_trace_check_passes(self, capsys):
        from repro_torch.launch.serve import main
        rc = main(["--trace", os.path.join(REPO, "examples", "traces",
                                           "smoke.jsonl"),
                   "--waves", "2", "--check", "--device", "cpu"])
        assert rc == 0, capsys.readouterr().err

    def test_help_is_the_scenario_server(self):
        from repro_torch.launch.serve import build_parser
        text = build_parser().format_help()
        assert "scenario server" in text and "--device" in text


# -------------------------- the port against JAX --------------------------- #

def _jax_serve(requests):
    from repro.serve import ScenarioServer as JaxServer
    with jax.threefry_partitionable(False):
        return JaxServer().serve(requests)


@pytest.mark.parametrize("engine", ["batched", "sublattice",
                                    "pallas_fused"])
def test_responses_equal_the_jax_servers(engine, jax_plain_fused):
    """Three requests that pack into one batch (different seeds, trial
    counts and budgets whose chunk boundaries interleave: 4, 5, 7, 10;
    park3's declared observables) and one of another scenario: each
    port response equals the JAX server's."""
    eng = {"engine": engine, "tile": [8, 8]}
    reqs = [req16(seed=3, mcs=10, n_trials=2, rid="a", engine=eng),
            req16(seed=9, mcs=7, n_trials=3, rid="b", engine=eng),
            req16(seed=2, mcs=4, n_trials=1, rid="d", engine=eng),
            req16(seed=4, mcs=7, n_trials=1, rid="c", engine=eng,
                  scenario="zhong_density")]
    want = _jax_serve([r.to_wire() for r in reqs])
    got = ScenarioServer(device="cpu").serve(reqs)
    for g, w in zip(got, want):
        assert g.ok and w.ok, (g.error, w.error)
        assert g.kind == w.kind == "trials"
        assert g.bucket == w.bucket and g.scenario_key == w.scenario_key
        assert_trial_results_equal(g.result, w.result)
        assert g.result.n_devices == w.result.n_devices == 1


JAX_MESH_CODE = """
import json
import jax
jax.config.update("jax_threefry_partitionable", False)
from repro.serve import ScenarioServer
reqs = json.loads(%r)
print(json.dumps([r.to_wire() for r in ScenarioServer().serve(reqs)]))
"""


def _mesh_requests():
    run = {"height": 16, "length": 16, "chunk_mcs": 3}
    sharded = {"engine": "sharded", "shard_grid": [2, 2], "tile": [8, 8]}
    pod = {"engine": "sharded_pod", "mesh_shape": [2, 2, 2],
           "tile": [8, 8]}
    return [
        SimRequest("park3", engine=sharded, run=dict(run, seed=3, mcs=6),
                   id="s1"),
        SimRequest("nspecies4", engine=sharded,
                   run=dict(run, seed=5, mcs=4, observables=()), id="s2"),
        SimRequest("park3", engine=pod, run=dict(run, seed=7, mcs=6),
                   n_trials=4, id="p1"),
        SimRequest("park3", engine=pod, run=dict(run, seed=8, mcs=3),
                   n_trials=3, id="p2"),
    ]


def test_mesh_engines_equal_the_jax_server(subproc):
    """``sharded`` on ``["cpu"] * 4`` and ``sharded_pod`` on ``["cpu"] *
    8`` against the JAX server on 8 fake devices, request for request."""
    reqs = _mesh_requests()
    out = subproc(JAX_MESH_CODE % json.dumps([r.to_wire() for r in reqs]),
                  8)
    want = [SimResponse.from_wire(w)
            for w in json.loads(out.strip().splitlines()[-1])]
    got = (ScenarioServer(device=["cpu"] * 4).serve(reqs[:2])
           + ScenarioServer(device=["cpu"] * 8).serve(reqs[2:]))
    for g, w in zip(got, want):
        assert g.ok and w.ok, (g.error, w.error)
        assert g.kind == w.kind and g.bucket == w.bucket
        if g.kind == "single":
            np.testing.assert_array_equal(g.result.grid, w.result.grid)
            assert set(g.result.observables) == set(w.result.observables)
            for k in g.result.observables:
                np.testing.assert_array_equal(g.result.observables[k],
                                              w.result.observables[k])
            assert g.result.mcs_completed == w.result.mcs_completed
            assert g.result.stasis_mcs == w.result.stasis_mcs
            assert g.result.kept_fraction == w.result.kept_fraction
        else:
            assert_trial_results_equal(g.result, w.result)
            assert g.result.n_devices == w.result.n_devices == 8


@pytest.mark.parametrize("engine", ["sublattice", "sharded", "sharded_pod"])
def test_no_build_and_bit_identity_on_meshes(engine):
    """Two same-bucket requests (different seeds and budgets) build once
    — one miss, one hit, no engine built by the second — and each equals
    its direct ``run_trials``/``simulate`` on the same devices."""
    single = engine == "sharded"
    sc = make_scenario("park3")
    if engine == "sharded_pod":
        ec, device = EngineConfig(engine=engine, mesh_shape=(2, 2, 2),
                                  tile=(8, 8)), ["cpu"] * 8
    elif engine == "sharded":
        ec, device = EngineConfig(engine=engine, shard_grid=(2, 2),
                                  tile=(8, 8)), ["cpu"] * 4
    else:
        ec, device = EngineConfig(engine=engine, tile=(8, 8)), ["cpu"] * 8

    def rc(seed, mcs):
        return RunConfig(height=32, length=32, mcs=mcs, chunk_mcs=4,
                         seed=seed, observables=())
    n = 1 if single else 4
    ra = SimRequest(sc, engine=ec, run=rc(3, 8), n_trials=n, id="a")
    rb = SimRequest(sc, engine=ec, run=rc(9, 16), n_trials=n, id="b")
    srv = ScenarioServer(device=device)
    resp_a = srv(ra)
    builds = engines.BUILDS
    resp_b = srv(rb)
    assert resp_a.ok, resp_a.error
    assert resp_b.ok, resp_b.error
    cache = srv.accounting()["cache"]
    assert cache["misses"] == 1 and cache["hits"] == 1, cache
    assert engines.BUILDS == builds
    assert resp_b.cache_hit and not resp_a.cache_hit
    for req, resp in ((ra, resp_a), (rb, resp_b)):
        if single:
            ref = simulate(sc, engine=ec, run=req.run, device=device)
            np.testing.assert_array_equal(resp.result.grid, ref.grid)
            np.testing.assert_array_equal(resp.result.densities,
                                          ref.densities)
            assert resp.result.mcs_completed == ref.mcs_completed
        else:
            assert_trial_results_equal(resp.result,
                                       direct_trials(req, device))
