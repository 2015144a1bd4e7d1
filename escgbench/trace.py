"""The traced window: ``torch.profiler`` over a run of chunks inside the
measured window, and its reduction to busy time, idle gaps, kernels and
launches.

The profiler starts at the first hook after the window's untraced first
half (``harness.Clock``) and stops ``chunks`` hooks later; every hook in between leaves a zero-length
``escgbench.chunk`` range, so the traced window is read in the trace's own
clock, from the first mark to the last. A device operation counts where it
overlaps that window, clipped to it; busy time is the union of those
intervals. Each idle gap is named by what the host was doing at its
middle: the benchmark's span (``escgbench.*``) there, else the innermost
host operation, else ``host`` (Python between operations).

A layer's device time is read from the same trace: each device operation
in the traced window (clipped to it) is matched to the host runtime call
that launched it (``cudaLaunchKernel``, ``cudaMemcpyAsync``, ..., which
shares its correlation id, also for the kernels the port launches
through ctypes), and counts for each of the benchmark's ranges that was
open when that call started.
"""
from __future__ import annotations

import bisect
import inspect
from typing import Dict, List, Optional

import torch

MARK = "escgbench.chunk"
# the kernels whose launches the program counts (kernels/*.py LAUNCHES)
COUNTED = {"K1": "tile_round_kernel", "K4": "density_kernel"}


def _launch_counts() -> Dict[str, int]:
    from repro_torch.kernels import density, escg_update_fused
    return {"K1": sum(escg_update_fused.LAUNCHES.values()),
            "K4": sum(density.LAUNCHES.values())}


class Tracer:
    def __init__(self, chunks: int):
        self.chunks = chunks
        self.prof = None
        self.first: Optional[int] = None
        self.done = False
        self.counted_at: List[Dict[str, int]] = []

    def _profile(self):
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        kw = {}
        if "acc_events" in inspect.signature(
                torch.profiler.profile).parameters:
            kw["acc_events"] = True
        return torch.profiler.profile(activities=acts, **kw)

    def hook(self, i: int) -> None:
        if self.done:
            return
        if self.prof is None:
            self.prof = self._profile()
            self.prof.start()
            self.first = i
        with torch.profiler.record_function(MARK):
            pass
        self.counted_at.append(_launch_counts())
        if i - self.first >= self.chunks:
            self.prof.stop()
            self.done = True

    def summary(self, chunk_mcs: int) -> Optional[dict]:
        """Busy and window seconds, the window's MCS, device ops and idle
        gaps (top 10 each), launches by the profiler and by the program's
        counters."""
        if self.prof is None:
            return None
        if not self.done:
            self.prof.stop()
            self.done = True
        events = self.prof.events()
        cuda = torch.autograd.DeviceType.CUDA
        marks, device, host, runtime = [], [], [], {}
        for e in events:
            tr = e.time_range
            if e.name == MARK:
                if e.device_type != cuda:
                    marks.append(tr.start)
            elif e.device_type != cuda:
                host.append((tr.start, tr.end, e.name))
                if e.name.startswith("cu"):
                    runtime[e.id] = tr.start
            elif not e.name.startswith("escgbench."):
                device.append((tr.start, tr.end, e.name, e.id))
        marks.sort()
        if len(marks) < 2:
            return None
        t0, t1 = marks[0], marks[-1]
        clipped = sorted((max(a, t0), min(b, t1), n, i)
                         for a, b, n, i in device if b > t0 and a < t1)
        launched = [(runtime[i], b - a) for a, b, _, i in clipped
                    if i in runtime]
        busy, gaps, end = 0.0, [], t0
        by_name: Dict[str, float] = {}
        for a, b, n, _ in clipped:
            by_name[n] = by_name.get(n, 0.0) + (b - a)
            if a > end:
                gaps.append((end, a))
            if b > end:
                busy += b - max(a, end)
                end = b
        if end < t1:
            gaps.append((end, t1))
        kernels = [(a, n) for a, _, n, _ in device if t0 <= a < t1
                   and not n.startswith(("Memcpy", "Memset"))]
        counted = {k: sum(pat in n for _, n in kernels)
                   for k, pat in COUNTED.items()}
        counters = {k: self.counted_at[-1][k] - self.counted_at[0][k]
                    for k in COUNTED}
        return {
            "busy_s": busy * 1e-6, "window_s": (t1 - t0) * 1e-6,
            "mcs": (len(marks) - 1) * chunk_mcs,
            "kernels": len(kernels), "counted_by_profiler": counted,
            "counted_by_program": counters,
            "span_device_s": _span_device_s(host, launched),
            "linked_device_s": sum(took for _, took in launched) * 1e-6,
            "device_ops": sorted(([n, s * 1e-6] for n, s in by_name.items()),
                                 key=lambda r: -r[1])[:10],
            "idle_gaps": _name_gaps(gaps, host)}


def _span_device_s(host, launched) -> Dict[str, float]:
    """Device seconds of each of the benchmark's ranges (``escgbench.*``
    but the chunk marks): ``launched`` holds (host start of the launching
    call, device microseconds) of each device operation."""
    spans: Dict[str, list] = {}
    for a, b, n in host:
        if n.startswith("escgbench.") and n != MARK:
            spans.setdefault(n, []).append((a, b))
    out = {}
    for name, ivs in spans.items():
        ivs.sort()
        starts = [a for a, _ in ivs]
        total = 0.0
        for t, took in launched:
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and ivs[i][1] >= t:
                total += took
        out[name] = total * 1e-6
    return out


def _covering(events, starts, t, look):
    """The latest-starting of ``events`` (sorted by start) that covers
    ``t``, looking back at most ``look`` of them: the innermost."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 1 - look), -1):
        if events[j][1] >= t:
            return events[j][2]
    return None


def _name_gaps(gaps, host) -> list:
    """Idle seconds summed by what the host ran at each gap's middle, the
    ten largest: the benchmark's span there, else the innermost host op."""
    spans = sorted(e for e in host if e[2].startswith("escgbench."))
    ops = sorted(e for e in host if not e[2].startswith("escgbench."))
    span_starts = [a for a, _, _ in spans]
    op_starts = [a for a, _, _ in ops]
    total: Dict[str, float] = {}
    for a, b in gaps:
        mid = (a + b) / 2
        name = (_covering(spans, span_starts, mid, 8)
                or _covering(ops, op_starts, mid, 64) or "host")
        total[name] = total.get(name, 0.0) + (b - a) * 1e-6
    return sorted(([n, s] for n, s in total.items()),
                  key=lambda r: -r[1])[:10]
