"""Where a path's time goes on the card.

    PYTHONPATH=src python -m repro_torch.perf_probe [--engine E] [--out FILE]
        [--local-kernel K] [--trials N] [--mesh-shape P,R,C]

Runs park3 at 3200 x 3200 on engine ``E`` (default ``pallas_fused``, the
main path of ``chip_smoke.py``) and reports:

* the host time of the per-MCS key chain (the engine's ``schedule`` over
  one chunk, divided by its MCS);
* for the stream-fed ``pallas`` engine, the device time of one MCS's
  proposal draws, ``rng.tile_stream_batch``, by CUDA events;
* for the default ``batched`` engine, the device time of one MCS's
  proposal draws (``rng.proposal_batch`` for each of its sub-batches) and
  of its arbitration windows (``batched.run_proposals``), by CUDA events;
* for the sequential ``reference`` engine, the device time of one MCS's
  proposal draws (one ``rng.proposal_batch`` of N) and of its scan (one
  S1 launch), by CUDA events;
* for each window, the wall time per MCS of a ``simulate`` window, one
  chunk of 100 MCS (10 on ``batched``) after a warm-up run, and from a
  ``torch.profiler`` trace of the same window the device time per MCS by
  kernel, K4's (or K4s's) and S1's among them, and the device's idle
  share, 1 - busy / wall.

``pallas_fused`` runs windows at ``k_mcs`` 1 and 10 with observables off;
``pallas`` and ``batched`` run one window with park3's declared
observables (``densities``, ``interface_length``), the path users call.
``batched`` launches some 9,000 small kernels per MCS, so its window is
10 MCS; ``reference`` runs one window of 5 MCS with observables off.
``sharded`` runs one window of 50 MCS with ``--local-kernel`` (K,
default ``fused``, observables off; ``pallas`` with park3's declared
observables) on a (2, 2) mesh of four ``cuda:0`` entries, the whole
decomposition on one card. (The plain
``sublattice`` engine launches some 7,700 per MCS and is not offered.)
With ``--trials N`` it probes the trial driver instead (``trials.
run_trials``, ``E`` one of ``pallas_fused``, ``pallas``, ``batched``,
``sharded_pod``): N trials of park3 at 3200 x 3200 (``pallas_fused``,
``pallas``, ``sharded_pod``; park3's declared observables) or of Park's
eight species at 100 x 100 (``batched``, the ``probabilistic`` preset),
in chunks of a quarter of a window, after a warm-up run.
``sharded_pod`` (only with ``--trials``) runs ``--local-kernel`` on a
``--mesh-shape`` mesh (default 2,2,2) of ``cuda:0`` entries, the whole
composed mesh on one card. It reports the host time per MCS of the
batched key chain of all N trials (``schedule_batch``), the steady wall
per MCS with ``async_stats`` on and off (a run of two windows less a run
of one, over a window), and from a trace
of the same chunks on lattices set up beforehand the device time per MCS
by kernel and the idle share of the steady wall; per trial too.

It prints one JSON object, also written to ``--out``. It needs a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from .core import batched, engines, lattice, reference, rng, threefry
from .core import observables as obs_mod
from .core.scenarios import (EngineConfig, RunConfig, compose,
                             make_scenario, resolve_config)
from .core.simulation import simulate
from .core.trials import build_trial_chunk, fold_trial_keys, run_trials
from .core.trials import make_trial_init as trials_init

SIDE, TILE = 3200, (8, 32)
SHARD_GRID = (2, 2)         # the sharded engine's mesh, all on cuda:0
# MCS in a profiled window, by engine
WINDOW = {"pallas_fused": 100, "pallas": 100, "batched": 10, "sharded": 50,
          "reference": 5}


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _window(engine: str, k_mcs: int, observables, device=None,
            **engine_kw) -> dict:
    window = WINDOW[engine]
    args = dict(engine=EngineConfig(engine=engine, tile=TILE, k_mcs=k_mcs,
                                    **engine_kw),
                run=RunConfig(length=SIDE, height=SIDE, mcs=window,
                              chunk_mcs=window, observables=observables),
                device=device)
    simulate(make_scenario("park3"), **args)            # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    simulate(make_scenario("park3"), **args)
    torch.cuda.synchronize()
    untraced = (time.perf_counter() - t0) / window * 1e3
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
                               + _device_us(evt) / window / 1e3)
    busy = sum(by_kernel.values())
    traced_ms = traced / window * 1e3
    return {"engine": engine, "k_mcs": k_mcs, "mcs": window, **engine_kw,
            "observables": "declared" if observables is None else "off",
            "wall_ms_per_mcs": untraced,
            "traced_wall_ms_per_mcs": traced_ms,
            "device_busy_ms_per_mcs": busy,
            "idle_share": 1.0 - busy / traced_ms,
            "k4_ms_per_mcs": sum(ms for name, ms in by_kernel.items()
                                 if "density_kernel" in name),
            "s1_ms_per_mcs": sum(ms for name, ms in by_kernel.items()
                                 if "reference_scan_kernel" in name),
            "device_ms_per_mcs_by_kernel": dict(
                sorted(by_kernel.items(), key=lambda kv: -kv[1]))}


# the trial windows: (scenario, side, MCS in a window of four chunks)
TRIAL_CELLS = {"pallas_fused": ("park3", SIDE, 20),
               "pallas": ("park3", SIDE, 4),
               "batched": ("probabilistic", 100, 12),
               "sharded_pod": ("park3", SIDE, 20)}


def _trial_window(engine: str, n_trials: int, devices=None,
                  **engine_kw) -> dict:
    """Steady-state wall per MCS of ``run_trials`` with ``n_trials``
    trials (``TRIAL_CELLS``): the wall of a run of twice the window less
    that of a run of the window, over the window, so the lattices' set-up
    drops out, with ``async_stats`` on and off. The device time per MCS
    by kernel of the same chunks (``build_trial_chunk`` on lattices set
    up beforehand, with the observables' rows) from a profiler trace, and
    the host time of the batched key chain of all trials."""
    name, side, window = TRIAL_CELLS[engine]
    chunk_mcs = window // 4
    sc = make_scenario(name)
    eng = EngineConfig(engine=engine, tile=TILE, **engine_kw)
    run = RunConfig(length=side, height=side, mcs=window,
                    chunk_mcs=chunk_mcs)

    def wall_s(mcs, async_stats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_trials(sc, n_trials=n_trials, engine=eng, run=run.replace(mcs=mcs),
                   stop_on_stasis=False, async_stats=async_stats,
                   device=devices)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def steady_ms(async_stats):
        # the set-up is the same for both lengths and drops out
        return (wall_s(2 * window, async_stats)
                - wall_s(window, async_stats)) / window * 1e3
    wall_s(window, True)                                # warm-up
    walls = {True: [], False: []}
    for async_stats in (True, False, True, False):
        walls[async_stats].append(steady_ms(async_stats))

    p, dom = resolve_config(sc, None, eng, run)
    p = p.validate()
    built = engines.build(p, dom, devices or "cuda")
    init = built.init_batch or trials_init(p, built.device)
    grids, keys = init(fold_trial_keys(threefry.PRNGKey(0), n_trials))
    chunk = build_trial_chunk(p, built, obs_mod.build_pipeline(p)
                              if p.observables else None)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(window // chunk_mcs):
            grids, keys = chunk(grids, keys, chunk_mcs)[:2]
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) / window * 1e3
    by_kernel = {}
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            key = evt.key[:100]
            by_kernel[key] = (by_kernel.get(key, 0.0)
                              + _device_us(evt) / window / 1e3)
    busy = sum(by_kernel.values())
    host = engines.build(p, dom, ["cpu"] * len(devices) if devices
                         else "cpu")
    t0 = time.perf_counter()
    host.schedule_batch(fold_trial_keys(threefry.PRNGKey(0), n_trials),
                        window)
    chain_us = (time.perf_counter() - t0) / window * 1e6
    wall = min(walls[True])
    return {"engine": engine, **engine_kw, "scenario": name,
            "lattice": f"{side}x{side}", "trials": n_trials, "mcs": window,
            "chunk_mcs": chunk_mcs, "observables": list(p.observables),
            "host_key_chain_us_per_mcs_all_trials": chain_us,
            "wall_ms_per_mcs_async": walls[True],
            "wall_ms_per_mcs_sync": walls[False],
            "wall_ms_per_mcs_per_trial": wall / n_trials,
            "traced_chunks_ms_per_mcs": traced_ms,
            "device_busy_ms_per_mcs": busy,
            "device_busy_ms_per_mcs_per_trial": busy / n_trials,
            "idle_share_of_steady_async_wall": 1.0 - busy / wall,
            "device_ms_per_mcs_by_kernel": dict(
                sorted(by_kernel.items(), key=lambda kv: -kv[1])[:25])}


def _event_ms(fn, n: int) -> float:
    """Device ms per call of ``fn`` by CUDA events over ``n`` calls after
    a warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def _stream_ms() -> float:
    """Device ms of one MCS's proposal draws at 3200 x 3200, by CUDA
    events over 10 draws after a warm-up draw."""
    p = compose(make_scenario("park3"), EngineConfig(engine="pallas",
                                                     tile=TILE),
                RunConfig(length=SIDE, height=SIDE))
    th, tw, n_tiles, k, interior = engines._tiled_setup(p)
    key = threefry.PRNGKey(0).cuda()
    ids = torch.arange(n_tiles, device="cuda")
    return _event_ms(lambda: rng.tile_stream_batch(key, ids, k, interior,
                                                   p.neighbourhood), 10)


def _batched_parts_ms() -> dict:
    """Device ms of one MCS's parts on ``batched`` at 3200 x 3200, by CUDA
    events over 5 MCS after a warm-up: the proposal draws of its
    sub-batches, and their arbitration windows."""
    park3 = make_scenario("park3")
    p = compose(park3, EngineConfig(engine="batched"),
                RunConfig(length=SIDE, height=SIDE))
    n = p.n_cells
    n_sub = engines._pick_sub_batches(n)
    keys = threefry.split(threefry.PRNGKey(0), n_sub)
    t_eps, t_eps_mu = p.action_thresholds()
    dom = torch.as_tensor(park3.dominance()).cuda()
    grid = lattice.init_grid(threefry.PRNGKey(1), SIDE, SIDE, p.species,
                             device="cuda")

    def draws():
        return [rng.proposal_batch(k, n // n_sub, n, p.neighbourhood,
                                   device="cuda") for k in keys]
    windows = draws()

    def arbitrate():
        g = grid
        for w in windows:
            g, _ = batched.run_proposals(g, w, t_eps, t_eps_mu, dom, p.flux)
    return {"sub_batches": n_sub,
            "proposal_batch_ms_per_mcs": _event_ms(draws, 5),
            "arbitration_ms_per_mcs": _event_ms(arbitrate, 5)}


def _reference_parts_ms() -> dict:
    """Device ms of one MCS's parts on ``reference`` at 3200 x 3200, by
    CUDA events over 3 MCS after a warm-up: the draws of its N proposals,
    and S1 applying them."""
    park3 = make_scenario("park3")
    p = compose(park3, EngineConfig(engine="reference"),
                RunConfig(length=SIDE, height=SIDE))
    n = p.n_cells
    t_eps, t_eps_mu = p.action_thresholds()
    dom = torch.as_tensor(park3.dominance()).cuda()
    grid = lattice.init_grid(threefry.PRNGKey(1), SIDE, SIDE, p.species,
                             device="cuda")
    key = threefry.PRNGKey(0)

    def draws():
        return rng.proposal_batch(key, n, n, p.neighbourhood, device="cuda")
    props = draws()
    return {"proposal_batch_ms_per_mcs": _event_ms(draws, 3),
            "s1_ms_per_mcs": _event_ms(lambda: reference.run_proposals(
                grid, props, t_eps, t_eps_mu, dom, p.flux), 3)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--engine", default="pallas_fused",
                    choices=tuple(WINDOW) + ("sharded_pod",))
    ap.add_argument("--out", default=None)
    ap.add_argument("--local-kernel", default="fused",
                    choices=("fused", "pallas", "jnp"))
    ap.add_argument("--trials", type=int, default=None,
                    help="probe run_trials with this many trials")
    ap.add_argument("--mesh-shape", default="2,2,2",
                    help="sharded_pod's (pod, rows, cols) mesh, P,R,C")
    args = ap.parse_args(argv)
    if args.trials is not None and args.engine not in TRIAL_CELLS:
        raise SystemExit(f"--trials takes --engine in {tuple(TRIAL_CELLS)}")
    if args.engine == "sharded_pod" and args.trials is None:
        raise SystemExit("--engine sharded_pod probes run_trials: pass "
                         "--trials N")
    mesh_shape = tuple(int(v) for v in args.mesh_shape.split(","))
    shard = {}
    if args.engine == "sharded":
        shard = dict(shard_grid=SHARD_GRID, local_kernel=args.local_kernel)
    n_blocks = SHARD_GRID[0] * SHARD_GRID[1]
    if not torch.cuda.is_available():
        raise SystemExit("perf_probe needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    if args.trials is not None:
        pod = {}
        if args.engine == "sharded_pod":
            pod = dict(devices=["cuda:0"] * (mesh_shape[0] * mesh_shape[1]
                                             * mesh_shape[2]),
                       mesh_shape=mesh_shape, local_kernel=args.local_kernel)
        return _emit({"card": card, "trial_window": _trial_window(
            args.engine, args.trials, **pod)}, args.out)
    built = engines.build(
        compose(make_scenario("park3"),
                EngineConfig(engine=args.engine, tile=TILE, **shard),
                RunConfig(length=SIDE, height=SIDE)),
        device=["cpu"] * n_blocks if shard else "cpu")
    t0 = time.perf_counter()
    built.schedule(threefry.PRNGKey(0), 100)
    chain_us = (time.perf_counter() - t0) / 100 * 1e6
    report = {"card": card, "engine": args.engine,
              "lattice": f"{SIDE}x{SIDE}", "tile": TILE,
              "host_key_chain_us_per_mcs": chain_us}
    if args.engine == "pallas_fused":
        report["windows"] = [_window(args.engine, 1, ()),
                             _window(args.engine, 10, ())]
    elif args.engine == "pallas":
        report["tile_stream_batch_ms_per_mcs"] = _stream_ms()
        report["windows"] = [_window(args.engine, 1, None)]
    elif args.engine == "sharded":
        report["windows"] = [_window(
            args.engine, 1, () if args.local_kernel == "fused" else None,
            ["cuda:0"] * n_blocks, **shard)]
    elif args.engine == "reference":
        report.update(_reference_parts_ms())
        report["windows"] = [_window(args.engine, 1, ())]
    else:
        report.update(_batched_parts_ms())
        report["windows"] = [_window(args.engine, 1, None)]
    return _emit(report, args.out)


def _emit(report: dict, out) -> int:
    text = json.dumps(report)
    print(text)
    if out:
        with open(out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
