"""The benchmark's files: BENCHMARK.json against its contract, every cell's
files found by name, the work counts, the import rules and the result
line's schema (CPU, small sizes)."""
import ast
import json
import math
import re
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from escgbench import harness, run  # noqa: E402
from escgbench.harness import LEAD  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SMALL = {"config": {"length": 64, "height": 32},
         "traffic": {"trials": 4, "chunk_mcs": 2, "trace_chunks": 2}}


def test_benchmark_json_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["escgbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [c["name"] for c in SPEC["configs"]] + \
        [w["name"] for w in SPEC["workloads"]] + \
        [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = {m["layer"] for m in SPEC["per_layer"]}
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and m["layer"] in layers
    assert "setup_s" in e2e
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_finds_its_files(cell):
    c = harness.load_cell(cell)
    assert c.chips == 1
    assert c.config["reduced"] == []
    for m in c.end_to_end + c.per_layer:
        assert (ROOT / "escgbench" / "metrics" / f"{m['name']}.py").exists()
    assert {m["name"] for m in c.end_to_end} >= {"setup_s", "updates_per_s"}
    model = c.model
    assert model.n_cells == 3200 * 3200
    for part in ["update", "counts"] + list(model.observables):
        assert part in c.work["parts"], part


@pytest.mark.parametrize("config", [c["name"] for c in SPEC["configs"]])
def test_config_is_the_programs_preset(config):
    from repro_torch.core.scenarios import make_scenario
    entry = {c["name"]: c for c in SPEC["configs"]}[config]
    cfg = json.loads((ROOT / entry["file"]).read_text())
    sc = make_scenario(cfg["scenario"])
    assert np.array_equal(np.asarray(sc.dominance())[1:, 1:],
                          np.asarray(cfg["dominance"]))
    assert (sc.species, sc.mobility) == (cfg["species"], cfg["mobility"])
    assert entry["source"] == cfg["source"]


@pytest.mark.parametrize("engine,tiles", [("pallas_fused", True),
                                          ("batched", False)])
def test_work_counts_equal_their_formulas(engine, tiles):
    cell = harness.load_cell(
        "park3-3200.fused-t16" if tiles else "park3-3200.batched-t8",
        overrides=SMALL)
    n = 64 * 32
    w = cell.work["parts"]
    # (8, 32) tiles of 64 x 32: 8 tiles of ceil(2048 / 8) = 256 proposals
    props = 8 * 256 if tiles else n
    instr, byts = harness.work_per_trial_mcs(cell, ["update"])
    assert instr == w["update"]["instructions_per_proposal"] * props
    assert byts == 2 * n * 4
    instr, byts = harness.work_per_trial_mcs(cell, None)
    assert instr == (w["update"]["instructions_per_proposal"] * props
                     + (w["counts"]["instructions_per_cell"]
                        + w["interface_length"]["instructions_per_cell"]) * n)
    assert byts == 2 * n * 4
    least = harness.least_seconds(cell, None, 3)
    assert math.isclose(least, 3 * max(
        instr / cell.peaks["issue_rate_per_s"],
        byts / cell.peaks["hbm_bytes_per_s"]))


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    p for p in (ROOT / "escgbench").rglob("*.py") if "tests" not in p.parts),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_reference_package(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "repro"}, tops
    assert "benchmarks" not in tops
    if "reference" in path.parts:
        assert "repro_torch" not in tops
        assert "escgbench" not in tops


def test_result_line_schema():
    out = run.run_cell("park3-3200.fused-t16", 2 ** 31 + 17, 0.5, False,
                       device="cpu", overrides=SMALL)
    assert list(out)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(out)
    assert out["correct"] is True and out["failed"] == 0
    units = {m["name"]: m["unit"] for m in SPEC["end_to_end"]}
    for name, m in out["metrics"].items():
        assert set(m) == {"value", "unit"} and m["unit"] == units[name]
    assert {"updates_per_s", "chunk_ms_p95", "setup_s"} <= \
        set(out["metrics"])
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(out)
    assert not run.loaded_forbidden()


def test_traced_run_on_the_cpu_reads_its_host_metrics():
    small = {"config": SMALL["config"],
             "traffic": dict(SMALL["traffic"], chunk_mcs=1)}
    out = run.run_cell("park3-3200.batched-t8", 2 ** 31 + 19, 1.0, True,
                       device="cpu", overrides=small)
    assert out["correct"] is True
    # no device on the CPU: the device-trace metrics find nothing to read
    assert {"keychain_ms_per_mcs", "mfu.mcs"} <= set(out["metrics"])
    assert not {"device_idle", "update_roofline", "draws_ms_per_mcs",
                "arbitration_ms_per_mcs"} & set(out["metrics"])
    assert out["device"]["busy_s"] == 0.0


def test_span_device_time_counts_launches_inside_each_range():
    from escgbench.trace import MARK, _span_device_s
    host = [(0.0, 100.0, "escgbench.update"), (10.0, 40.0,
            "escgbench.draws"), (50.0, 60.0, "escgbench.draws"),
            (5.0, 5.0, MARK), (120.0, 130.0, "escgbench.update")]
    launched = [(1.0, 2.0), (12.0, 3.0), (55.0, 4.0), (70.0, 5.0),
                (125.0, 6.0), (200.0, 7.0)]
    got = _span_device_s(host, launched)
    assert got == pytest.approx({"escgbench.update": 20e-6,
                                 "escgbench.draws": 7e-6})


def test_clock_reads_the_wall_before_the_trace():
    clock = harness.Clock(1.0, "cpu")
    clock.times = [0.0, 1.0, 2.0, 3.0, 5.0, 7.0, 9.0]
    clock.mcs = [10, 20, 30, 40, 50, 60, 70]
    assert clock.untraced_s_per_mcs() is None
    # window opens at times[LEAD - 1]; the trace started at times[4]
    clock.traced_from = 4
    assert clock.untraced_s_per_mcs() == pytest.approx(4.0 / 30)
    clock.traced_from = LEAD
    assert clock.untraced_s_per_mcs() is None


class _Tracer:
    def __init__(self, chunks):
        self.chunks, self.hooks, self.done = chunks, [], False

    def hook(self, i):
        self.hooks.append(i)
        self.done = i >= self.chunks


def test_clock_traces_after_the_untraced_half_and_waits_for_the_trace():
    tracer = _Tracer(3)
    clock = harness.Clock(4.0, torch.device("cpu"), tracer)
    now = [0.0]
    harness.time.perf_counter = lambda: now[0]
    try:
        for k in range(40):
            now[0] = float(k)
            try:
                clock(k * 10, None)
            except harness.WindowClosed:
                break
    finally:
        harness.time.perf_counter = time.perf_counter
    # opens at t = 1 (LEAD = 2), traces from t = 3, closes once the trace
    # is done (t = 6) though 4 s had passed at t = 5
    assert clock.traced_from == 3 and tracer.hooks == [0, 1, 2, 3]
    assert clock.times[-1] == 6.0
    assert clock.untraced_s_per_mcs() == pytest.approx(2.0 / 20)
