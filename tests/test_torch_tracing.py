"""The trial driver's spans (``repro_torch.core.tracing``) on the CPU: the
documented names and nesting, each span's study and chunk, results that
do not depend on them, the bounded ring beside totals that keep counting,
no profiler range while the profiler is off, and the same ranges in a
``torch.profiler`` trace while it is on."""
import collections

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import tracing
from repro_torch.core.scenarios import EngineConfig, RunConfig, make_scenario
from repro_torch.core.trials import run_trials

N_MCS, CHUNK = 4, 2
# the names of one run, each with the name of the span around it
NESTING = {
    "repro_torch.chunk": None, "repro_torch.wait": None,
    "repro_torch.fold": None,
    "repro_torch.keychain": "repro_torch.chunk",
    "repro_torch.schedule_copy": "repro_torch.chunk",
    "repro_torch.update": "repro_torch.chunk",
    "repro_torch.observables": "repro_torch.chunk",
    "repro_torch.ring_push": "repro_torch.chunk",
}
BATCHED_ONLY = {"repro_torch.draws": "repro_torch.update",
                "repro_torch.arbitration": "repro_torch.update"}


def small_run(engine, k_mcs=1, device="cpu", trials=4, shape=(64, 32)):
    """park3 (densities and interface length declared: the ring is used)
    at 64 x 32, 4 trials, 2-MCS chunks."""
    return run_trials(make_scenario("park3"), n_trials=trials,
                      key=torch.tensor([0, 7]), n_mcs=N_MCS,
                      chunk_mcs=CHUNK, stop_on_stasis=False,
                      engine=EngineConfig(engine=engine, tile=(8, 32),
                                          k_mcs=k_mcs),
                      run=RunConfig(length=shape[0], height=shape[1]),
                      device=device)


def traced_run(engine, **kw):
    tracing.reset()
    result = small_run(engine, **kw)
    return result, tracing.spans()


def _within(inner, outer):
    return outer.start <= inner.start <= inner.end <= outer.end


@pytest.mark.parametrize("engine", ["pallas_fused", "batched"])
def test_spans_carry_the_documented_names_and_nest(engine):
    _, recs = traced_run(engine)
    want = dict(NESTING, **(BATCHED_ONLY if engine == "batched" else {}))
    assert {r.name for r in recs} == set(want)
    for r in recs:
        assert r.parent == want[r.name], r
        assert r.start <= r.end
    # one study, two chunks, each with its enqueue, wait and fold
    assert len({r.study for r in recs}) == 1
    chunks = N_MCS // CHUNK
    by = collections.Counter((r.name, r.chunk) for r in recs)
    for c in range(chunks):
        for name in ("repro_torch.chunk", "repro_torch.wait",
                     "repro_torch.fold", "repro_torch.keychain",
                     "repro_torch.ring_push"):
            assert by[(name, c)] == 1, (name, c)
        # an update and a row of observables a MCS
        assert by[("repro_torch.update", c)] == CHUNK
        assert by[("repro_torch.observables", c)] == CHUNK
    assert {r.chunk for r in recs} == set(range(chunks))
    # every child lies inside a span of its parent's name and its chunk
    for r in recs:
        if r.parent is not None:
            assert any(p.name == r.parent and p.chunk == r.chunk
                       and _within(r, p) for p in recs), r
    # the enqueue of chunk c precedes the wait for it, which precedes its fold
    for c in range(chunks):
        enq, = (r for r in recs if r.name == "repro_torch.chunk"
                and r.chunk == c)
        wait, = (r for r in recs if r.name == "repro_torch.wait"
                 and r.chunk == c)
        fold, = (r for r in recs if r.name == "repro_torch.fold"
                 and r.chunk == c)
        assert enq.end <= wait.start <= wait.end <= fold.start


def test_launches_of_several_mcs_copy_the_attempts_too():
    _, recs = traced_run("pallas_fused", k_mcs=2)
    by = collections.Counter((r.name, r.chunk) for r in recs)
    for c in range(N_MCS // CHUNK):
        # the key chain's copy and the attempts' copy
        assert by[("repro_torch.schedule_copy", c)] == 2
        # one launch of both MCS; the held grid values and the held rows
        assert by[("repro_torch.update", c)] == 1
        assert by[("repro_torch.observables", c)] == 2
    assert all(r.parent == NESTING[r.name] for r in recs)


def test_each_unit_of_a_pod_tags_its_chunks():
    tracing.reset()
    small_run("batched", device=["cpu"] * 2)
    recs = tracing.spans()
    enq = [r for r in recs if r.name == "repro_torch.chunk"]
    assert sorted((r.chunk, r.pod) for r in enq) == [(0, 0), (0, 1),
                                                      (1, 0), (1, 1)]
    for r in recs:
        if r.parent == "repro_torch.chunk":
            assert r.pod in (0, 1)
    assert {r.pod for r in recs if r.parent is None
            and r.name != "repro_torch.chunk"} == {None}


def test_every_study_gets_its_own_number():
    tracing.reset()
    small_run("batched")
    small_run("batched")
    studies = sorted({r.study for r in tracing.spans()})
    assert len(studies) == 2 and studies[1] > studies[0]


@pytest.mark.parametrize("engine", ["pallas_fused", "batched"])
def test_spans_change_no_result(engine):
    first = small_run(engine)
    tracing.reset()
    again = small_run(engine)
    assert first.to_json() == again.to_json()
    with profile(activities=[ProfilerActivity.CPU]):
        traced = small_run(engine, trials=1)
    assert traced.to_json() == small_run(engine, trials=1).to_json()


def test_ring_keeps_its_length_and_totals_count_past_it():
    tracing.reset()
    extra = 10
    for i in range(tracing.RING + extra):
        with tracing.span("test.tick", chunk=i):
            pass
    recs = tracing.spans()
    assert len(recs) == tracing.RING
    # the oldest dropped out
    assert recs[0].chunk == extra
    assert recs[-1].chunk == tracing.RING + extra - 1
    total = tracing.totals()["test.tick"]
    assert total.calls == tracing.RING + extra
    assert total.seconds >= sum(r.end - r.start for r in recs)
    tracing.reset()
    assert tracing.spans() == [] and tracing.totals() == {}


def test_tags_are_inherited_and_a_span_closes_on_an_exception():
    tracing.reset()
    with pytest.raises(ValueError):
        with tracing.span("test.outer", study=3, chunk=4, pod=5):
            with tracing.span("test.inner"):
                raise ValueError("inside")
    inner, outer = tracing.spans()
    assert (inner.name, inner.parent) == ("test.inner", "test.outer")
    assert (inner.study, inner.chunk, inner.pod) == (3, 4, 5)
    assert outer.parent is None and _within(inner, outer)
    # the stack is empty again: a new span is top-level
    with tracing.span("test.after"):
        pass
    assert tracing.spans()[-1].parent is None


class _Counting:
    """A profiler range that counts its entries."""
    entered = 0

    def __init__(self, name, *args):
        self.name = name

    def __enter__(self):
        type(self).entered += 1
        return self

    def __exit__(self, *exc):
        return False


def test_no_profiler_range_while_the_profiler_is_off(monkeypatch):
    counted = type("Counted", (_Counting,), {"entered": 0})
    monkeypatch.setattr(tracing, "_RecordFunctionFast", counted)
    monkeypatch.setattr(torch.profiler, "record_function", counted)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", counted)
    tracing.reset()
    small_run("batched")
    assert tracing.spans() and counted.entered == 0
    # while the profiler is on, every span opens one range
    with profile(activities=[ProfilerActivity.CPU]):
        tracing.reset()
        small_run("batched")
    assert counted.entered == len(tracing.spans())


@pytest.mark.parametrize("engine", ["pallas_fused", "batched"])
def test_profiler_trace_holds_the_same_ranges_nested_alike(engine):
    # the profiler records every operation: one trial of 32 x 16
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tracing.reset()
        small_run(engine, trials=1, shape=(32, 16))
    recs = tracing.spans()
    ranges = [e for e in prof.events() if e.name.startswith("repro_torch.")]
    assert collections.Counter(e.name for e in ranges) == \
        collections.Counter(r.name for r in recs)

    def program_parent(e):
        p = e.cpu_parent
        while p is not None and not p.name.startswith("repro_torch."):
            p = p.cpu_parent
        return None if p is None else p.name

    assert collections.Counter((e.name, program_parent(e)) for e in ranges) \
        == collections.Counter((r.name, r.parent) for r in recs)
    # host ranges only: no range of the program on a device's timeline
    assert all(e.device_type == torch.autograd.DeviceType.CPU
               for e in ranges)
