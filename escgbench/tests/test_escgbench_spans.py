"""The readers of the program's spans (``spans.py``) on the CPU: the
reduction over the window's untraced first half (clipping, self time
less children, per-MCS division), idle gaps named by the program's
innermost range, and a traced run that reads the host metrics."""
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from escgbench import harness, run, spans  # noqa: E402
from escgbench.trace import MARK, Tracer  # noqa: E402

from repro_torch.core.tracing import Span  # noqa: E402

SMALL = {"config": {"length": 64, "height": 32},
         "traffic": {"trials": 4, "chunk_mcs": 2, "trace_chunks": 2}}
HOST = ["keychain_host_ms_per_mcs", "enqueue_ms_per_mcs",
        "blocked_ms_per_mcs", "wait_ms_per_mcs", "fold_ms_per_mcs"]


def _clock(times, mcs, traced_from):
    clock = harness.Clock(1.0, torch.device("cpu"))
    clock.times, clock.mcs, clock.traced_from = times, mcs, traced_from
    return clock


def _span(name, start, end, parent=None):
    return Span(name, start, end, parent, 0, 0, 0)


def test_untraced_half_is_the_window_before_the_tracer():
    # the window opens at times[LEAD - 1] = 1.0; the tracer starts at 4.0
    clock = _clock([0.0, 1.0, 2.0, 3.0, 4.0, 5.0], [10, 20, 30, 40, 50, 60],
                   4)
    assert spans.untraced_half(clock) == (1.0, 4.0, 30)
    clock.traced_from = None
    assert spans.untraced_half(clock) is None
    clock.traced_from = harness.LEAD - 1
    assert spans.untraced_half(clock) is None


def test_host_ms_per_mcs_clips_to_the_half_and_takes_children_out():
    half = (10.0, 20.0, 5)               # 10 s, 5 MCS
    recs = [
        _span("p.chunk", 8.0, 12.0),     # 2 s inside
        _span("p.keychain", 8.5, 11.0, "p.chunk"),   # 1 s inside
        _span("p.chunk", 13.0, 16.0),    # 3 s
        _span("p.keychain", 13.0, 14.0, "p.chunk"),  # 1 s
        _span("p.copy", 14.0, 14.5, "p.chunk"),      # 0.5 s
        _span("p.copy", 15.0, 15.5, "p.other"),      # another parent
        _span("p.chunk", 19.0, 25.0),    # 1 s inside
        _span("p.chunk", 30.0, 31.0),    # outside
    ]
    ms = spans.host_ms_per_mcs
    assert ms(recs, half, "p.chunk") == pytest.approx(6.0 / 5 * 1e3)
    assert ms(recs, half, "p.keychain") == pytest.approx(2.0 / 5 * 1e3)
    assert ms(recs, half, "p.copy") == pytest.approx(1.0 / 5 * 1e3)
    # less the children: only those whose parent is the span
    assert ms(recs, half, "p.chunk", ["p.keychain", "p.copy"]) == \
        pytest.approx((6.0 - 2.0 - 0.5) / 5 * 1e3)
    # a span that is not there, or records that may have lost the
    # half's start, give nothing
    assert ms(recs, half, "p.wait") is None
    assert ms(recs[2:], (12.5, 20.0, 5), "p.chunk") is None
    assert ms([], half, "p.chunk") is None and ms(recs, None,
                                                  "p.chunk") is None


def test_readers_find_nothing_in_a_program_without_spans(monkeypatch):
    monkeypatch.setattr(spans, "program_spans", lambda: None)
    clock = _clock([0.0, 1.0, 2.0, 3.0], [0, 10, 20, 30], 3)
    ctx = SimpleNamespace(clock=clock, trace=None)
    for name in HOST:
        assert run.read_metric(name, ctx) is None
    assert run.read_metric("idle_keychain_ms_per_mcs", ctx) is None


def test_blocked_sums_the_copies_to_the_card(monkeypatch):
    recs = [_span("repro_torch.chunk", 0.0, 10.0),
            _span("repro_torch.schedule_copy", 1.0, 2.0,
                  "repro_torch.chunk"),
            _span("repro_torch.ring_push", 5.0, 8.0, "repro_torch.chunk"),
            _span("repro_torch.keychain", 2.0, 4.0, "repro_torch.chunk")]
    monkeypatch.setattr(spans, "program_spans", lambda: recs)
    ctx = SimpleNamespace(clock=_clock([-1.0, 0.0, 10.0], [0, 0, 4], 2),
                          trace=None)
    assert run.read_metric("blocked_ms_per_mcs", ctx) == \
        pytest.approx(4.0 / 4 * 1e3)
    assert run.read_metric("enqueue_ms_per_mcs", ctx) == \
        pytest.approx(4.0 / 4 * 1e3)
    assert run.read_metric("keychain_host_ms_per_mcs", ctx) == \
        pytest.approx(2.0 / 4 * 1e3)


def test_idle_gaps_are_named_by_the_innermost_program_range():
    host = [(0.0, 100.0, "repro_torch.chunk"),
            (10.0, 40.0, "repro_torch.keychain"),
            (50.0, 60.0, "repro_torch.update"),
            (52.0, 58.0, "aten::add"),       # not a program range
            (120.0, 130.0, "repro_torch.fold")]
    gaps = [(20.0, 30.0),     # middle 25: keychain, inside chunk
            (54.0, 56.0),     # middle 55: update (aten::add is not one)
            (70.0, 80.0),     # middle 75: the chunk alone
            (110.0, 112.0),   # middle 111: no program range
            (124.0, 128.0)]   # middle 126: fold
    got = spans.idle_by_range(gaps, host)
    assert got == pytest.approx({"repro_torch.keychain": 10.0,
                                 "repro_torch.update": 2.0,
                                 "repro_torch.chunk": 10.0, None: 2.0,
                                 "repro_torch.fold": 4.0})


class _Event:
    def __init__(self, name, start, end, cuda=False, eid=0):
        self.name, self.id = name, eid
        self.time_range = SimpleNamespace(start=start, end=end)
        self.device_type = (torch.autograd.DeviceType.CUDA if cuda
                            else torch.autograd.DeviceType.CPU)


def _events():
    return [
        _Event(MARK, 0.0, 0.0), _Event(MARK, 100.0, 100.0),
        _Event(MARK, 200.0, 200.0),
        _Event("repro_torch.chunk", 0.0, 150.0),
        _Event("repro_torch.keychain", 5.0, 60.0),
        _Event("cudaLaunchKernel", 70.0, 71.0, eid=1),
        _Event("cudaLaunchKernel", 72.0, 73.0, eid=2),
        # device work: 60-90 and 95-120, and one before the window
        _Event("kernel_a", 60.0, 90.0, cuda=True, eid=1),
        _Event("kernel_b", 95.0, 120.0, cuda=True, eid=2),
        _Event("kernel_c", -20.0, -10.0, cuda=True),
        # the benchmark's annotation on the device is no work
        _Event("escgbench.update", 0.0, 200.0, cuda=True),
    ]


def test_idle_gaps_match_the_traced_windows_busy_time():
    gaps, host, n = spans.idle_gaps(_events())
    assert gaps == [(0.0, 60.0), (90.0, 95.0), (120.0, 200.0)]
    assert n == 2
    tracer = Tracer(2)
    tracer.prof = SimpleNamespace(events=_events)
    tracer.done = True
    tracer.counted_at = [{"K1": 0, "K4": 0}] * 2
    summary = tracer.summary(5)
    idle = sum(b - a for a, b in gaps) * 1e-6
    assert idle == pytest.approx(summary["window_s"] - summary["busy_s"])
    ctx = SimpleNamespace(clock=SimpleNamespace(tracer=tracer),
                          trace=summary)
    # 10 MCS; 0-60 has its middle inside the key chain: 60 us
    assert spans.idle_ms_per_mcs(ctx, "keychain") == \
        pytest.approx(60.0 * 1e-3 / 10)
    assert run.read_metric("idle_keychain_ms_per_mcs", ctx) == \
        pytest.approx(60.0 * 1e-3 / 10)
    # no such range in the trace: nothing to read
    assert spans.idle_ms_per_mcs(ctx, "fold") is None


def test_traced_run_on_the_cpu_reads_the_span_metrics():
    small = {"config": SMALL["config"],
             "traffic": dict(SMALL["traffic"], chunk_mcs=1)}
    out = run.run_cell("park3-3200.fused-t16", 2 ** 31 + 23, 1.0, True,
                       device="cpu", overrides=small)
    assert out["correct"] is True
    for name in HOST:
        assert out["metrics"][name]["value"] >= 0.0, name
        assert out["metrics"][name]["unit"] == "ms"
    # no device on the CPU: the device trace's metric finds nothing
    assert "idle_keychain_ms_per_mcs" not in out["metrics"]
