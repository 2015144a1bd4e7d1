"""Fault tolerance (port of ``repro.runtime.fault``): checkpoint/restart
loop, straggler monitor, elastic restore (DESIGN.md §9).

The same manifest-driven checkpoints back a restart-on-failure training
loop and an elastic path that places any checkpoint onto another layout.
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .checkpoint import CheckpointManager

log = logging.getLogger("repro_torch.runtime")


@dataclass
class StragglerMonitor:
    """Flags steps whose wall time exceeds k x running median — on real
    fleets this triggers node replacement; here it logs and counts."""
    k: float = 3.0
    window: int = 50
    times: List[float] = field(default_factory=list)
    flagged: int = 0

    def record(self, dt: float) -> bool:
        self.times.append(dt)
        hist = self.times[-self.window:]
        if len(hist) >= 10:
            med = float(np.median(hist[:-1]))
            if dt > self.k * med:
                self.flagged += 1
                log.warning("straggler step: %.3fs > %.1fx median %.3fs",
                            dt, self.k, med)
                return True
        return False


@dataclass
class Heartbeat:
    """Liveness marker a fleet supervisor would watch."""
    path: str
    interval_s: float = 30.0
    _last: float = 0.0

    def beat(self, step: int) -> None:
        now = time.time()
        if now - self._last >= self.interval_s:
            with open(self.path, "w") as f:
                f.write(f"{step} {now}\n")
            self._last = now


class FaultTolerantLoop:
    """Run (state, batch) -> (state, metrics) with periodic checkpoints and
    restart-from-latest on failure.

    ``max_restarts`` bounds crash loops; ``inject_failure`` lets tests
    exercise the restart path deterministically. A restart restores onto
    ``shardings`` (see ``CheckpointManager.restore``), else onto the
    manager's device.
    """

    def __init__(self, step_fn: Callable, ckpt: CheckpointManager,
                 ckpt_every: int = 100, max_restarts: int = 3,
                 straggler: Optional[StragglerMonitor] = None,
                 heartbeat: Optional[Heartbeat] = None):
        self.step_fn = step_fn
        self.ckpt = ckpt
        self.ckpt_every = ckpt_every
        self.max_restarts = max_restarts
        self.straggler = straggler or StragglerMonitor()
        self.heartbeat = heartbeat
        self.restarts = 0

    def run(self, state: Any, batches: Callable[[int], Any], n_steps: int,
            start_step: int = 0,
            inject_failure: Optional[Callable[[int], bool]] = None,
            shardings: Any = None,
            on_metrics: Optional[Callable[[int, Dict], None]] = None):
        step = start_step
        while step < n_steps:
            try:
                t0 = time.time()
                if inject_failure is not None and inject_failure(step):
                    raise RuntimeError(f"injected failure at step {step}")
                state, metrics = self.step_fn(state, batches(step))
                dt = time.time() - t0
                self.straggler.record(dt)
                if self.heartbeat:
                    self.heartbeat.beat(step)
                if on_metrics:
                    on_metrics(step, metrics)
                step += 1
                if step % self.ckpt_every == 0 or step == n_steps:
                    self.ckpt.save(step, state, blocking=False)
            except Exception as e:                      # noqa: BLE001
                self.restarts += 1
                log.error("step %d failed (%s); restart %d/%d", step, e,
                          self.restarts, self.max_restarts)
                if self.restarts > self.max_restarts:
                    raise
                self.ckpt.wait()
                latest = self.ckpt.latest_step()
                if latest is None:
                    step = start_step     # no checkpoint yet: retry from go
                    continue
                step, state = self.ckpt.restore(latest, shardings=shardings)
        self.ckpt.wait()
        return state, step


def elastic_restore(ckpt: CheckpointManager, new_shardings: Any,
                    step: Optional[int] = None):
    """Resume on a DIFFERENT layout: the checkpoint's global arrays are
    placed onto `new_shardings` (restore is layout-agnostic): a device, a
    ``LatticeMesh`` or a ``(DeviceMesh, placements)`` pair per leaf, so a
    state saved on one mesh (by either package) lands on another."""
    return ckpt.restore(step, shardings=new_shardings)
