#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the port's CUDA kernels from
``src/repro_torch/kernels/csrc``, holds each against its plain PyTorch
version on the card, reproduces ``tests/golden/fused_trajectory.json``
through ``simulate`` on the card, drives the main path (park3 at
3200 x 3200 on the ``pallas_fused`` engine, ``k_mcs`` 1 and 10) through
the entry points a user calls, times every kernel, and prints one JSON
line per kernel table and, last, ``{"ok": true, "device": ...}``. Any
failure raises and exits non-zero; without a CUDA card, or without the
repository around it, it exits non-zero before printing a result. It
imports nothing of JAX.
"""
import hashlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "golden", "fused_trajectory.json")

SIDE, TILE, MCS, CHUNK = 3200, (8, 32), 200, 100
K_MCS = 10
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
# Instructions one elementary update needs at the least: Philox-4x32-10
# with its round keys in registers is 10 rounds of 2 wide multiplies (hi
# and lo in one instruction) and 2 three-input xors = 40; the counter 1;
# cell = x0 % interior with its row and column 8; dirn 1; two uniforms 4;
# neighbour offsets and addresses 6; 2 cell loads, 2 dominance loads and 2
# stores 6; the rule (5 compares, 1 add, 6 selects) 12; loop control 2.
OPS_PER_UPDATE = 80
# K2's roll and count per cell and step: 2 loads, 1 store, 1 shared-memory
# atomic and 4 index instructions.
OPS_PER_CELL = 8


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def smi(query):
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def grid_hash(grid):
    return hashlib.sha256(
        grid.cpu().numpy().astype("<i4").tobytes()).hexdigest()


def event_ms(torch, fn, n):
    """Mean ms of ``fn`` over ``n`` calls, by CUDA events after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def max_err(torch, a, b):
    return float((a.long() - b.long()).abs().max()) if a.numel() else 0.0


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card; the port's smoke test needs one",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    import numpy as np
    from repro_torch.core import engines, lattice, threefry
    from repro_torch.core.scenarios import (EngineConfig, RunConfig,
                                            compose, make_scenario)
    from repro_torch.core.simulation import simulate
    from repro_torch.kernels import build
    from repro_torch.kernels import escg_update_fused as fused

    check(not any(m == "jax" or m.startswith("jax.") for m in sys.modules),
          "the port imported jax")
    dev = torch.device("cuda")
    card = smi("name,power.limit")
    print(card, flush=True)

    # ---- 2. build ----
    t0 = time.perf_counter()
    build.build()
    print(f"[build] nvcc {time.perf_counter() - t0:.2f}s")
    for line in build.build_log("escg_update_fused").splitlines():
        if "registers" in line or "spill" in line:
            print("[build]", line.strip())

    # the main path's configuration and kernel inputs
    park3 = make_scenario("park3")
    run = RunConfig(length=SIDE, height=SIDE, mcs=MCS, chunk_mcs=CHUNK,
                    observables=())
    p = compose(park3, EngineConfig(engine="pallas_fused", tile=TILE), run)
    te, tem = p.action_thresholds()
    th, tw = TILE
    n_tiles = (SIDE // th) * (SIDE // tw)
    k = -(-p.n_cells // n_tiles)            # proposals per tile and MCS
    dom = torch.as_tensor(park3.dominance()).to(dev)
    dirs = torch.as_tensor(lattice.DIRS).to(dev)

    def grid_on_card(side, species, dtype, seed):
        return lattice.init_grid(threefry.PRNGKey(seed), side, side, species,
                                 0.1, dtype=dtype, device=dev)

    # ---- 3. K1 against its plain version ----
    k1_err = 0.0
    g_main = grid_on_card(SIDE, 3, torch.int32, 0)
    for seed, rule in (((0x9E3779B9, 7), (te, tem)),
                       ((12345, 67890), (0.25, 0.6)),
                       ((2 ** 32 - 1, 3), (0.25, 0.6))):
        a = fused.escg_tile_round_fused(g_main, seed, 0, dom, dirs, TILE, k,
                                        *rule, 4)
        b = fused.escg_tile_round_fused_plain(g_main, seed, 0, dom, TILE, k,
                                              *rule, 4)
        torch.cuda.synchronize()
        err = max_err(torch, a, b)
        k1_err = max(k1_err, err)
        print(f"[K1] {SIDE}x{SIDE} int32 nbhd 4 seed {seed} thresholds "
              f"{rule}: max_abs_err {err}, cells changed "
              f"{int((a != g_main).sum())}")
    g8 = grid_on_card(512, 5, torch.int8, 1)
    dom5 = torch.as_tensor(make_scenario("nspecies5").dominance()).to(dev)
    k8 = (512 * 512) // ((512 // th) * (512 // tw))
    for offset, gtw in (((0, 0), None), ((3, 7), 111)):
        a = fused.escg_tile_round_fused(g8, (5, 6), 2, dom5, dirs, TILE, k8,
                                        0.25, 0.6, 8, offset, gtw)
        b = fused.escg_tile_round_fused_plain(g8, (5, 6), 2, dom5, TILE, k8,
                                              0.25, 0.6, 8, offset, gtw)
        torch.cuda.synchronize()
        err = max_err(torch, a, b)
        k1_err = max(k1_err, err)
        print(f"[K1] 512x512 int8 nbhd 8 tile_offset {offset} grid_tiles_w "
              f"{gtw}: max_abs_err {err}")
    check(k1_err == 0.0, f"K1 disagrees with its plain version ({k1_err})")

    # ---- 4. K2 against its plain version ----
    _, seeds_h, shifts_h = engines.multi_round_inputs(threefry.PRNGKey(1),
                                                      th, tw, K_MCS)
    seeds, shifts = seeds_h.to(dev), shifts_h.to(dev)
    ga, ca = fused.escg_tile_rounds_fused(g_main, seeds, shifts, dom, dirs,
                                          TILE, k, te, tem, 3, 4)
    gb, cb = fused.escg_tile_rounds_fused_plain(g_main, seeds, shifts, dom,
                                                TILE, k, te, tem, 3, 4)
    torch.cuda.synchronize()
    k2_err = max(max_err(torch, ga, gb), max_err(torch, ca, cb))
    print(f"[K2] {SIDE}x{SIDE} K={K_MCS}: max_abs_err {k2_err} (grid and "
          f"counts), cooperative blocks "
          f"{fused.cooperative_blocks(g_main, 3)}, counts[-1] "
          f"{ca[-1].tolist()}")
    check(k2_err == 0.0, f"K2 disagrees with its plain version ({k2_err})")

    # ---- 5. the fused golden through simulate on the card ----
    with open(GOLDEN) as f:
        want = json.load(f)
    hashes = []
    res = simulate(make_scenario("nspecies5", mobility=1e-3, empty=0.1),
                   engine=EngineConfig(engine="pallas_fused", tile=(8, 8)),
                   run=RunConfig(length=16, height=16, mcs=5, chunk_mcs=1,
                                 seed=11, observables=()),
                   stop_on_stasis=False,
                   hooks=[lambda m, g, c: hashes.append(grid_hash(g))])
    check(hashes == want["grid_hashes"], "golden grid hashes differ")
    check(np.array_equal(res.densities, np.asarray(want["densities"])),
          "golden densities differ")
    check(hashlib.sha256(res.grid.astype("<i4").tobytes()).hexdigest()
          == want["final_hash"], "golden final hash differs")
    print("[golden] tests/golden/fused_trajectory.json reproduced on the "
          "card: 5 grid hashes, densities, final hash")

    # ---- 6. the main path ----
    results, launches = {}, {}
    for k_mcs in (1, K_MCS):
        stamps = []
        fused.reset_launches()
        t0 = time.perf_counter()
        r = simulate(park3,
                     engine=EngineConfig(engine="pallas_fused", tile=TILE,
                                         k_mcs=k_mcs),
                     run=run,
                     hooks=[lambda m, g, c: stamps.append(
                         time.perf_counter())])
        wall = time.perf_counter() - t0
        launches[k_mcs] = dict(fused.LAUNCHES)
        results[k_mcs] = r
        dens = r.densities
        check(r.grid.shape == (SIDE, SIDE) and r.grid.dtype == np.int32,
              "final lattice has the wrong shape or dtype")
        check(dens.shape == (MCS + 1, 4) and np.isfinite(dens).all()
              and np.abs(dens.sum(axis=1) - 1.0).max() < 1e-12,
              "densities are not finite rows of shares")
        check(r.grid.min() >= 0 and r.grid.max() <= 3, "labels out of range")
        per_mcs = (stamps[1] - stamps[0]) / CHUNK * 1e3
        print(f"[main] park3 {SIDE}x{SIDE} k_mcs={k_mcs}: {r.mcs_completed} "
              f"MCS in {wall:.3f}s incl. set-up; second chunk "
              f"{per_mcs:.4f} ms/MCS; launches {launches[k_mcs]}; final "
              f"densities {dens[-1].tolist()}")
    check(launches[1]["escg_tile_round_fused"] == MCS
          and launches[1]["escg_tile_rounds_fused"] == 0,
          f"k_mcs=1 did not run through K1: {launches[1]}")
    check(launches[K_MCS]["escg_tile_rounds_fused"] == MCS // K_MCS
          and launches[K_MCS]["escg_tile_round_fused"] == 0,
          f"k_mcs={K_MCS} did not run through K2: {launches[K_MCS]}")
    check(np.array_equal(results[1].grid, results[K_MCS].grid)
          and np.array_equal(results[1].densities,
                             results[K_MCS].densities),
          f"k_mcs={K_MCS} differs from k_mcs=1")
    print(f"[main] k_mcs={K_MCS} equals k_mcs=1: final lattice and all "
          f"{MCS + 1} density rows")

    # ---- 7. kernel times and bounds ----
    clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    instr_per_s = sms * 4 * 32 * clock_hz   # 4 schedulers, 32 lanes each
    cell_bytes = g_main.element_size() * SIDE * SIDE
    updates = n_tiles * k

    def bound(n_bytes, n_ops):
        by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        by_ops = n_ops / instr_per_s * 1e3
        return (max(by_bytes, by_ops),
                "bytes" if by_bytes >= by_ops else "operations")

    k1_ms = event_ms(torch, lambda: fused.escg_tile_round_fused(
        g_main, (1, 2), 0, dom, dirs, TILE, k, te, tem, 4), 50)
    k1_plain = event_ms(torch, lambda: fused.escg_tile_round_fused_plain(
        g_main, (1, 2), 0, dom, TILE, k, te, tem, 4), 2)
    k1_bound, k1_by = bound(2 * cell_bytes, updates * OPS_PER_UPDATE)
    k2_ms = event_ms(torch, lambda: fused.escg_tile_rounds_fused(
        g_main, seeds, shifts, dom, dirs, TILE, k, te, tem, 3, 4), 10)
    k2_plain = event_ms(torch, lambda: fused.escg_tile_rounds_fused_plain(
        g_main, seeds, shifts, dom, TILE, k, te, tem, 3, 4), 1)
    k2_bound, k2_by = bound(
        2 * cell_bytes + K_MCS * 4 * 4 + seeds.numel() * 16,
        K_MCS * (updates * OPS_PER_UPDATE + SIDE * SIDE * OPS_PER_CELL))
    for name, ms, plain, bnd, by in (
            ("K1", k1_ms, k1_plain, k1_bound, k1_by),
            (f"K2 (K={K_MCS})", k2_ms, k2_plain, k2_bound, k2_by)):
        print(f"[time] {name}: {ms:.4f} ms per launch, plain {plain:.2f} "
              f"ms, bound {bnd * 1e3:.1f} us by {by} (instruction rate "
              f"{instr_per_s / 1e12:.2f} T/s at {clock_hz / 1e9:.2f} GHz); "
              f"library call: none computes a sequential tile sweep")

    # ---- 8. the kernel table ----
    src = "src/repro_torch/kernels/csrc/escg_update_fused.cu"
    print(json.dumps({"kernels": [
        {"name": "escg_tile_round_fused", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/escg_update_fused.py:130",
         "launches": launches[1]["escg_tile_round_fused"],
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain,
         "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": None},
        {"name": "escg_tile_rounds_fused", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/escg_update_fused.py:252",
         "launches": launches[K_MCS]["escg_tile_rounds_fused"],
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain,
         "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": None},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
