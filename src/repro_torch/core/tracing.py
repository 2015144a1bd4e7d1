"""Spans of the trial driver: where the host's time goes, on the clock of
the caller and, while PyTorch's profiler runs, on the device trace's.

``span(name)`` is a context manager. When it closes it appends one
``Span`` record ``(name, start, end, parent, study, chunk, pod)`` to a
bounded in-memory ring (``RING`` records; the oldest drop out) and adds
its seconds to a per-name total that never drops anything. ``start`` and
``end`` are ``time.perf_counter()`` seconds, the clock of any caller's
hook. ``parent`` is the name of the span that was open around it on the
same thread, ``None`` at the top. ``study`` counts the calls of
``trials.run_trials`` in the process (``new_study``), ``chunk`` is the
chunk's ordinal in its study and ``pod`` the unit of the trial driver
(a device's slice of the trials) that ran it; a span given none of
them takes its parent's.

While the profiler is on, a span also opens a range of its name in the
profiler's trace (``_RecordFunctionFast``), on the device trace's clock:
every device operation launched inside it is linked by correlation id to
a runtime call that the range encloses. It is a host range only.
``torch.profiler.record_function`` would also leave a user annotation of
the name on the device's timeline, spanning the device work of the
range, which a reader that takes every device event for work would count
as a kernel. With the profiler off a span opens no range: a flag check
and two clock reads, where a ``record_function`` costs some 10 us.

The spans of ``trials.run_trials`` (every other call of the driver's
functions leaves its spans too, with ``study`` ``None``):

=========================  ================================================
``repro_torch.chunk``      one chunk's enqueue on one unit, from the key
                           chain to the host copies and the event record
``repro_torch.keychain``   the host threefry chain of the chunk's MCS
                           (``BuiltEngine.schedule_batch``)
``repro_torch.schedule_copy``  the chain's copy to the device through
                           pinned memory, which does not wait for the
                           device (and under ``k_mcs > 1`` the kept
                           counts' fill on the device)
``repro_torch.update``     one ``one_mcs_batch`` or ``multi_mcs_batch``
``repro_torch.draws``      ``batched``'s proposal draws in the update
``repro_torch.arbitration``  ``batched``'s arbitration in the update
``repro_torch.observables``  the observables' rows of the chunk's MCS
``repro_torch.ring_push``  the rows' push into the device ring: one or two
                           slice writes at slots the host knows, no copy
                           from the host and no wait for the device
``repro_torch.wait``       the host blocked on the device for a chunk's
                           copies to the host
``repro_torch.fold``       the ring's flush and the fold of the masks
                           into the statistics
=========================  ================================================

``chunk`` holds ``keychain``, ``schedule_copy``, ``update`` (which holds
``draws`` and ``arbitration``), ``observables`` and ``ring_push``;
``wait`` and ``fold`` are top-level, and the caller's hooks run outside
every span. Nothing is written to a file: ``spans()``, ``totals()`` and
``reset()`` read and clear the records.
"""
from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Optional

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _autograd_profiler

# records the ring keeps: a study of 3200^2 lattices leaves a few hundred
# spans a second, so the ring holds minutes of it
RING = 1 << 16

CHUNK = "repro_torch.chunk"
KEYCHAIN = "repro_torch.keychain"
SCHEDULE_COPY = "repro_torch.schedule_copy"
UPDATE = "repro_torch.update"
DRAWS = "repro_torch.draws"
ARBITRATION = "repro_torch.arbitration"
OBSERVABLES = "repro_torch.observables"
RING_PUSH = "repro_torch.ring_push"
WAIT = "repro_torch.wait"
FOLD = "repro_torch.fold"


class Span(NamedTuple):
    name: str
    start: float                 # time.perf_counter() seconds
    end: float
    parent: Optional[str]        # the enclosing span's name
    study: Optional[int]
    chunk: Optional[int]
    pod: Optional[int]


class Total(NamedTuple):
    calls: int
    seconds: float


# plain tuples in the ring, made ``Span`` records when read: a record
# costs some 0.1 us to keep, against 0.7 us as a NamedTuple
_ring: "collections.deque[tuple]" = collections.deque(maxlen=RING)
_totals: Dict[str, List] = {}
_studies = itertools.count()
_local = threading.local()


def new_study() -> int:
    """The next study's number (one a ``run_trials`` call)."""
    return next(_studies)


class span:
    """``with span(name, study=..., chunk=..., pod=...):`` records the
    block's host time as ``name`` (module docstring)."""

    __slots__ = ("name", "tags", "parent", "start", "_range", "_stack")

    def __init__(self, name: str, study: Optional[int] = None,
                 chunk: Optional[int] = None, pod: Optional[int] = None):
        self.name = name
        self.tags = (study, chunk, pod)

    def __enter__(self) -> "span":
        try:
            stack = _local.stack
        except AttributeError:
            stack = _local.stack = []
        self._stack = stack
        if stack:
            outer = stack[-1]
            self.parent = outer.name
            if self.tags == (None, None, None):
                self.tags = outer.tags
        else:
            self.parent = None
        stack.append(self)
        self._range = None
        if _autograd_profiler._is_profiler_enabled:
            self._range = _RecordFunctionFast(self.name)
            self._range.__enter__()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.perf_counter()
        if self._range is not None:
            self._range.__exit__(*exc)
        self._stack.pop()
        name, start = self.name, self.start
        _ring.append((name, start, end, self.parent) + self.tags)
        total = _totals.get(name)
        if total is None:
            total = _totals[name] = [0, 0.0]
        total[0] += 1
        total[1] += end - start
        return False


def spans() -> List[Span]:
    """The ring's records, oldest first."""
    return [Span(*r) for r in list(_ring)]


def totals() -> Dict[str, Total]:
    """Calls and seconds of every span name since the last ``reset``,
    whatever the ring has dropped."""
    return {name: Total(*t) for name, t in list(_totals.items())}


def reset() -> None:
    """Clear the ring and the totals (the study numbers go on)."""
    _ring.clear()
    _totals.clear()
