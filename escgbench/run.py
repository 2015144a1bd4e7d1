"""Run one cell of the benchmark once and print its result line.

    python3 -m escgbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout. It needs a CUDA card (``torch.cuda``) and
exits non-zero with no result without one. The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics; with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each number compared beside its limit (also the last lines of
standard error).

A run: the kernels' libraries built or found in
``src/repro_torch/kernels/_build/``; the study, whose lead chunks are
set-up and whose next chunks are the measured window (``harness``); the
check against the reference (``check``); the metrics, each read by
``metrics/<name>.py``.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the benchmark's package at the root, the study's (the port) under src/
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from escgbench.harness import process_age  # noqa: E402

STARTED = T0 - process_age()

import numpy as np  # noqa: E402
import torch  # noqa: E402

from escgbench import check, harness  # noqa: E402
from escgbench.trace import Tracer  # noqa: E402

# top-level module names that may not be loaded when the result is printed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class NoCard(RuntimeError):
    pass


@dataclass
class Context:
    """What a metric's reader reads: the cell, the window's clock, the
    traced window's summary (or None), the set-up seconds and the study's
    key chain as its first chunk called it."""
    cell: harness.Cell
    clock: harness.Clock
    trace: Optional[dict]
    setup_s: float
    keychain: harness.KeyChain

    def least_s(self, parts=None) -> float:
        """Least seconds of one MCS of all the cell's trials (``parts`` of
        the work file, or the whole step)."""
        return harness.least_seconds(self.cell, parts, self.cell.trials)

    def untraced_s_per_mcs(self) -> Optional[float]:
        """Wall seconds an MCS of the window's untraced first half (the
        profiler slows the host); None without a trace."""
        return self.clock.untraced_s_per_mcs()

    def span_ms_per_mcs(self, span: str) -> Optional[float]:
        """Device ms an MCS launched inside the benchmark's range ``span``
        in the traced window; None where the trace holds none."""
        t = self.trace
        took = t["span_device_s"].get(span) if t and t["mcs"] else None
        return took / t["mcs"] * 1e3 if took else None


def read_metric(name: str, ctx: Context):
    path = harness.HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"escgbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", overrides: Optional[dict] = None,
             root: Path = ROOT, started: float = STARTED) -> dict:
    """One run of the cell ``name``; returns the result line's object."""
    marks = [time.perf_counter()]
    cell = harness.load_cell(name, root, overrides)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            raise NoCard(f"cell {name} needs {cell.chips} CUDA card(s); "
                         f"torch sees "
                         f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        from repro_torch.kernels import build
        build.build()
    key = harness.run_key(seed)
    model = cell.model
    chunk = cell.chunk
    marks.append(time.perf_counter())

    sample = check.draw(seed, cell.trials)
    capture = harness.Capture(check.start_points(sample, chunk), sample.late,
                              (model.height, model.width),
                              getattr(torch, cell.config["cell_dtype"]),
                              pinned=dev.type == "cuda")
    tracer = Tracer(int(cell.traffic["trace_chunks"])) if trace else None
    late = {}

    def on_open(chunk_s: float) -> None:
        # chunk c in the first half of the window, from the lead chunk's time
        c = sample.chunk_c(harness.LEAD, 0.5 * seconds / chunk_s)
        capture.add_late((c - 1) * chunk, c * chunk)
        clock.until = late["c"] = c

    clock = harness.Clock(seconds, dev, tracer, on_open)
    flushed, keychain = [], harness.KeyChain()
    marks.append(time.perf_counter())
    with harness.watched_study(capture, flushed, trace, keychain):
        harness.study(cell, key, dev, clock)
    harness.sync(dev)
    after = [time.perf_counter()]
    summary = tracer.summary(chunk) if tracer is not None else None
    after.append(time.perf_counter())
    setup_s = clock.times[harness.LEAD - 1] - started
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    numbers, bad = check.compare(
        model, cell.engine, key, sample, chunk, late["c"],
        check.ProgramOutputs(capture, flushed), dev, cell.k_mcs)
    limits = check.limits()
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = all(v <= limits[k] for k, v in numbers.items())
    after.append(time.perf_counter())
    del capture, flushed
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ctx = Context(cell, clock, summary, setup_s, keychain)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = read_metric(m["name"], ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    after.append(time.perf_counter())
    if dev.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": cell.chips}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1}
    info["memory_peak_bytes"] = clock.peak_bytes
    out = {"correct": bool(correct),
           "attempted": cell.trials * clock.window_chunks,
           "failed": int(bad), "metrics": metrics, "device": info}
    if summary is not None:
        info["busy_s"] = summary["busy_s"]
        info["window_s"] = summary["window_s"]
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
        out["launches"] = {"by_profiler": summary["counted_by_profiler"],
                           "by_program": summary["counted_by_program"],
                           "kernels": summary["kernels"],
                           "mcs": summary["mcs"]}
        out["launches"]["linked_device_s"] = summary["linked_device_s"]
    out["window"] = {"seconds": clock.window_s, "mcs": clock.window_mcs,
                     "chunks": clock.window_chunks,
                     "chunk_ms_median": float(np.median(
                         clock.intervals_ms())),
                     "sample": {"start": sample.start, "late": sample.late,
                                "chunk": late["c"]}}
    marks.append(clock.times[harness.LEAD - 1])
    out["setup"] = dict(zip(("imports", "card_and_kernels",
                             "sample_and_capture", "lattices_and_lead_chunks"),
                            np.diff([started] + marks).tolist()))
    out["after"] = dict(zip(("stop", "trace", "check", "metrics"),
                            np.diff([clock.times[-1]] + after).tolist()))
    out["checks"] = checks
    return out


def loaded_forbidden():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        out = run_cell(args.workload, args.seed, args.seconds,
                       bool(args.trace))
    except NoCard as e:
        print(f"escgbench: {e}", file=sys.stderr)
        return 2
    found = loaded_forbidden()
    if found:
        print(f"escgbench: the process loaded {found}; the benchmark runs "
              "the port alone", file=sys.stderr)
        return 3
    for k, v in out["checks"].items():
        print(f"check {k} = {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
