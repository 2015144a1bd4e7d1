"""Where the main path's time goes on the card.

    PYTHONPATH=src python -m repro_torch.perf_probe [--out FILE]

Runs park3 at 3200 x 3200 on the ``pallas_fused`` engine (the main path of
``chip_smoke.py``) and reports, for ``k_mcs`` 1 and 10:

* the host time of the per-MCS key chain (``engines.multi_round_inputs``
  over one chunk, divided by its MCS);
* the wall time per MCS of a ``simulate`` window, one chunk of 100 MCS
  after a warm-up run;
* from a ``torch.profiler`` trace of the same window, the device time per
  MCS by kernel and the device's idle share, 1 - busy / wall.

It prints one JSON object, also written to ``--out``. It needs a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from .core import engines, threefry
from .core.scenarios import EngineConfig, RunConfig, make_scenario
from .core.simulation import simulate

SIDE, TILE, WINDOW = 3200, (8, 32), 100


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _window(k_mcs: int) -> dict:
    args = dict(engine=EngineConfig(engine="pallas_fused", tile=TILE,
                                    k_mcs=k_mcs),
                run=RunConfig(length=SIDE, height=SIDE, mcs=WINDOW,
                              chunk_mcs=WINDOW, observables=()))
    simulate(make_scenario("park3"), **args)            # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    simulate(make_scenario("park3"), **args)
    torch.cuda.synchronize()
    untraced = (time.perf_counter() - t0) / WINDOW * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        simulate(make_scenario("park3"), **args)
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    by_kernel = {}
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[evt.key[:60]] = _device_us(evt) / WINDOW / 1e3
    busy = sum(by_kernel.values())
    traced_ms = traced / WINDOW * 1e3
    return {"k_mcs": k_mcs, "wall_ms_per_mcs": untraced,
            "traced_wall_ms_per_mcs": traced_ms,
            "device_busy_ms_per_mcs": busy,
            "idle_share": 1.0 - busy / traced_ms,
            "device_ms_per_mcs_by_kernel": dict(
                sorted(by_kernel.items(), key=lambda kv: -kv[1]))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("perf_probe needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    engines.multi_round_inputs(threefry.PRNGKey(0), *TILE, WINDOW)
    chain_us = (time.perf_counter() - t0) / WINDOW * 1e6
    report = {"card": card, "lattice": f"{SIDE}x{SIDE}", "tile": TILE,
              "host_key_chain_us_per_mcs": chain_us,
              "windows": [_window(1), _window(10)]}
    text = json.dumps(report)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
