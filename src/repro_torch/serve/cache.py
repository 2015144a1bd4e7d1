"""LRU built-engine cache (port of ``repro.serve.cache``, DESIGN.md §12).

Building is the serving tax: an engine build (its tables on the device,
its chunk closures) costs more than a small batch takes to run. The cache
keys the built state by ``(BucketKey, scenario_key)`` — the bucket fixes
every knob that shapes the engine, the scenario hash fixes the physics
bound into it — so a request stream that revisits a (shape, physics) pair
builds once until LRU pressure evicts it.

In the reference an entry is a jitted chunk, and a retrace is a grow of
its jit caches. The port traces nothing: an entry is a *built engine* —
the ``BuiltEngine`` of each device and their chunk closures — and what a
repeat bucket must not do is build again. So ``trace_count`` counts
engine builds (``engines.BUILDS``, every ``engines.build`` of the
process; the executor runs serially, so the builds made while an entry
runs are that entry's), and ``retraces`` counts the batches served from a
cache hit during which an engine was built: an executor path that builds
per request (``simulate`` instead of ``simulation.run_built``, say)
shows there. A chunk of a new length builds nothing in the port, so
``length_traces`` stays 0; it is kept so that the report's fields are the
reference's and ``loadgen.check_report`` reads both servers' reports
alike."""
from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from ..core import engines
from ..core.params import EscgParams
from .bucketing import BucketKey

__all__ = ["BuiltEntry", "EngineCache"]

CacheKey = Tuple[BucketKey, str]


@dataclass
class BuiltEntry:
    """Everything reusable across batches of one (bucket, scenario): the
    params template, the dominance matrix, the execution kind, and the
    built engines with their chunks — one *unit* per device of a trial
    batch (``executor.Unit``; a ``sharded_pod`` mesh is one unit), or the
    one engine and chunk of the single-lattice path."""
    key: Any
    params: Optional[EscgParams]   # template: seed/mcs/trials vary per job
    dom: np.ndarray
    kind: str                      # 'pod' | 'vmap' | 'single'
    units: Tuple[Any, ...] = ()    # trial kinds: (built, init, chunk) each
    chunk_fn: Optional[Callable] = None   # the single-lattice chunk
    pipe: Optional[object] = None  # ObsPipeline when observables stream
    built: Optional[object] = None  # BuiltEngine of the single kind
    pod_width: int = 1             # trial-axis padding multiple
    n_devices: int = 1             # devices a batch runs on (TrialResult)
    build_s: float = 0.0           # wall time of the build (miss cost)
    runs: int = 0                  # batches served
    _build_mark: int = 0

    def trace_count(self) -> int:
        """Engine builds of the process so far."""
        return engines.BUILDS

    def mark_traced(self) -> None:
        self._build_mark = self.trace_count()

    def retraced(self) -> bool:
        """True when an engine was built since the last ``mark_traced``."""
        return self.trace_count() > self._build_mark


@dataclass
class EngineCache:
    """Ordered-dict LRU over :class:`BuiltEntry` with accounting."""
    max_entries: int = 8
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    retraces: int = 0              # batches served from a hit that built
    _entries: "OrderedDict[CacheKey, BuiltEntry]" = field(
        default_factory=OrderedDict)

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: CacheKey) -> bool:
        return key in self._entries

    def get_or_build(self, key: CacheKey,
                     builder: Callable[[], BuiltEntry]
                     ) -> Tuple[BuiltEntry, bool]:
        """The cached entry for ``key``, built (and timed) on a miss.
        Returns ``(entry, hit)``; a hit moves the entry to MRU position.
        Either way the entry's build count is marked, so ``note_run``
        sees the builds of the batch that follows."""
        entry = self._entries.get(key)
        if entry is not None:
            self._entries.move_to_end(key)
            self.hits += 1
            entry.mark_traced()
            return entry, True
        self.misses += 1
        t0 = time.perf_counter()
        entry = builder()
        entry.build_s = time.perf_counter() - t0
        entry.key = key
        entry.mark_traced()
        self._entries[key] = entry
        while len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)
            self.evictions += 1
        return entry, False

    def note_run(self, entry: BuiltEntry) -> None:
        """After the batch that followed ``get_or_build``: a warm entry
        (one that had served a batch before) that built an engine during
        it counts a retrace."""
        if entry.runs > 0 and entry.retraced():
            self.retraces += 1
        entry.runs += 1

    def accounting(self) -> Dict[str, Any]:
        return {
            "entries": len(self._entries),
            "max_entries": self.max_entries,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "retraces": self.retraces,
            "length_traces": 0,        # a chunk length compiles nothing
            "hit_rate": (self.hits / (self.hits + self.misses)
                         if (self.hits + self.misses) else 0.0),
        }
