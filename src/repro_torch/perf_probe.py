"""Where a path's time goes on the card.

    PYTHONPATH=src python -m repro_torch.perf_probe [--engine E] [--out FILE]

Runs park3 at 3200 x 3200 on engine ``E`` (default ``pallas_fused``, the
main path of ``chip_smoke.py``) and reports:

* the host time of the per-MCS key chain (the engine's ``schedule`` over
  one chunk, divided by its MCS);
* for the stream-fed ``pallas`` engine, the device time of one MCS's
  proposal draws, ``rng.tile_stream_batch``, by CUDA events;
* for each window, the wall time per MCS of a ``simulate`` window, one
  chunk of 100 MCS after a warm-up run, and from a ``torch.profiler``
  trace of the same window the device time per MCS by kernel and the
  device's idle share, 1 - busy / wall.

``pallas_fused`` runs windows at ``k_mcs`` 1 and 10 with observables off;
``pallas`` runs one window with park3's declared observables
(``densities``, ``interface_length``), the path users call. (The plain
``sublattice`` engine launches some 7,700 small kernels per MCS, more
than a profiler window holds in reasonable time, and is not offered.) It
prints one JSON object, also written to ``--out``. It needs a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from .core import engines, rng, threefry
from .core.scenarios import (EngineConfig, RunConfig, compose,
                             make_scenario)
from .core.simulation import simulate

SIDE, TILE, WINDOW = 3200, (8, 32), 100


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _window(engine: str, k_mcs: int, observables) -> dict:
    args = dict(engine=EngineConfig(engine=engine, tile=TILE, k_mcs=k_mcs),
                run=RunConfig(length=SIDE, height=SIDE, mcs=WINDOW,
                              chunk_mcs=WINDOW, observables=observables))
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
            name = evt.key[:100]
            by_kernel[name] = (by_kernel.get(name, 0.0)
                               + _device_us(evt) / WINDOW / 1e3)
    busy = sum(by_kernel.values())
    traced_ms = traced / WINDOW * 1e3
    return {"engine": engine, "k_mcs": k_mcs,
            "observables": "declared" if observables is None else "off",
            "wall_ms_per_mcs": untraced,
            "traced_wall_ms_per_mcs": traced_ms,
            "device_busy_ms_per_mcs": busy,
            "idle_share": 1.0 - busy / traced_ms,
            "device_ms_per_mcs_by_kernel": dict(
                sorted(by_kernel.items(), key=lambda kv: -kv[1]))}


def _stream_ms() -> float:
    """Device ms of one MCS's proposal draws at 3200 x 3200, by CUDA
    events over 10 draws after a warm-up draw."""
    p = compose(make_scenario("park3"), EngineConfig(engine="pallas",
                                                     tile=TILE),
                RunConfig(length=SIDE, height=SIDE))
    th, tw, n_tiles, k, interior = engines._tiled_setup(p)
    key = threefry.PRNGKey(0).cuda()
    ids = torch.arange(n_tiles, device="cuda")

    def draw():
        return rng.tile_stream_batch(key, ids, k, interior, p.neighbourhood)
    draw()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        draw()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / 10


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--engine", default="pallas_fused",
                    choices=("pallas_fused", "pallas"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("perf_probe needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    built = engines.build(
        compose(make_scenario("park3"),
                EngineConfig(engine=args.engine, tile=TILE),
                RunConfig(length=SIDE, height=SIDE)), device="cpu")
    t0 = time.perf_counter()
    built.schedule(threefry.PRNGKey(0), WINDOW)
    chain_us = (time.perf_counter() - t0) / WINDOW * 1e6
    report = {"card": card, "engine": args.engine,
              "lattice": f"{SIDE}x{SIDE}", "tile": TILE,
              "host_key_chain_us_per_mcs": chain_us}
    if args.engine == "pallas_fused":
        report["windows"] = [_window(args.engine, 1, ()),
                             _window(args.engine, 10, ())]
    else:
        report["tile_stream_batch_ms_per_mcs"] = _stream_ms()
        report["windows"] = [_window(args.engine, 1, None)]
    text = json.dumps(report)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
