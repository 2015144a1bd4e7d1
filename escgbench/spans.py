"""The program's own spans (``repro_torch.core.tracing``) read for the
per-layer metrics: host ms an MCS of each span over the window's
untraced first half, and the device's idle time in the traced window
named by the program's innermost range.

The untraced half runs from the window's opening, ``clock.times[LEAD -
1]``, to the tracer's start, ``clock.times[clock.traced_from]``; its MCS
are ``clock.mcs[traced_from] - clock.mcs[LEAD - 1]``. A span counts the
part of it that lies in the half. A program without the spans (a tree
older than them) gives nothing to read, and every reader returns None.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

import torch

from .harness import LEAD
from .trace import MARK, _covering

PREFIX = "repro_torch."
# ranges to look back over for the innermost one around a time: a chunk
# of the program holds some 25 (an update and a row a MCS, 10-MCS chunks)
LOOK = 64


def program_spans() -> Optional[list]:
    """The program's span records, oldest first; None where the program
    has no spans."""
    try:
        from repro_torch.core import tracing
    except ImportError:
        return None
    return tracing.spans()


def untraced_half(clock) -> Optional[Tuple[float, float, int]]:
    """(start, end, MCS) of the window's untraced first half; None
    without a tracer or where the half holds no MCS."""
    i, j = LEAD - 1, clock.traced_from
    if j is None or j <= i:
        return None
    mcs = clock.mcs[j] - clock.mcs[i]
    return (clock.times[i], clock.times[j], mcs) if mcs > 0 else None


def clipped_s(records: Iterable, name: str, t0: float, t1: float,
              parent: Optional[str] = None) -> Optional[float]:
    """Seconds of the spans ``name`` (whose parent is ``parent``, where
    given) inside [t0, t1]; None where no such span overlaps it."""
    total, found = 0.0, False
    for r in records:
        if r.name != name or (parent is not None and r.parent != parent):
            continue
        a, b = max(r.start, t0), min(r.end, t1)
        if b >= a:
            total += b - a
            found = True
    return total if found else None


def host_ms_per_mcs(records: Optional[Sequence], half, name: str,
                    less: Sequence[str] = ()) -> Optional[float]:
    """Host ms an MCS of the spans ``name`` over ``half`` (``untraced_half``),
    less the time of their children named in ``less``; None where the
    records miss the span or may have dropped part of the half."""
    if not records or half is None:
        return None
    t0, t1, mcs = half
    if records[0].start > t0:          # the ring no longer reaches back
        return None
    took = clipped_s(records, name, t0, t1)
    if took is None:
        return None
    for child in less:
        took -= clipped_s(records, child, t0, t1, parent=name) or 0.0
    return took / mcs * 1e3


def read_host(ctx, name: str, less: Sequence[str] = ()) -> Optional[float]:
    """``host_ms_per_mcs`` of the run behind ``ctx`` (``run.Context``)."""
    return host_ms_per_mcs(program_spans(), untraced_half(ctx.clock),
                           PREFIX + name, [PREFIX + c for c in less])


def idle_gaps(events) -> Tuple[List[Tuple[float, float]], list, int]:
    """The device's idle gaps in the traced window (the span between the
    first and the last chunk mark), as ``trace.Tracer.summary`` computes
    them, the host events and the count of device operations in the
    window; times in the trace's microseconds."""
    cuda = torch.autograd.DeviceType.CUDA
    marks, device, host = [], [], []
    for e in events:
        tr = e.time_range
        if e.name == MARK:
            if e.device_type != cuda:
                marks.append(tr.start)
        elif e.device_type != cuda:
            host.append((tr.start, tr.end, e.name))
        elif not e.name.startswith("escgbench."):
            device.append((tr.start, tr.end))
    marks.sort()
    if len(marks) < 2:
        return [], host, 0
    t0, t1 = marks[0], marks[-1]
    clipped = sorted((max(a, t0), min(b, t1)) for a, b in device
                     if b > t0 and a < t1)
    gaps, end = [], t0
    for a, b in clipped:
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if end < t1:
        gaps.append((end, t1))
    return gaps, host, len(clipped)


def idle_by_range(gaps, host) -> dict:
    """Idle microseconds summed by the innermost of the program's ranges
    (``repro_torch.*``) open at each gap's middle; ``None`` collects the
    gaps outside them."""
    ranges = sorted(e for e in host if e[2].startswith(PREFIX))
    starts = [a for a, _, _ in ranges]
    out: dict = {}
    for a, b in gaps:
        name = _covering(ranges, starts, (a + b) / 2, LOOK)
        out[name] = out.get(name, 0.0) + (b - a)
    return out


def idle_ms_per_mcs(ctx, name: str) -> Optional[float]:
    """Device idle ms an MCS of the traced window whose gaps' middles lie
    in the program's range ``name``; None without a traced window, device
    operations in it, or such a range."""
    tracer = getattr(ctx.clock, "tracer", None)
    t = ctx.trace
    if tracer is None or tracer.prof is None or not t or not t["mcs"]:
        return None
    events = tracer.prof.events()
    gaps, host, n_device = idle_gaps(events)
    name = PREFIX + name
    if not n_device or not any(e[2] == name for e in host):
        return None
    return idle_by_range(gaps, host).get(name, 0.0) * 1e-3 / t["mcs"]
