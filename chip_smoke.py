#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the port's CUDA kernels (K1-K5,
K4s and S1) from ``src/repro_torch/kernels/csrc``, holds each against its
plain PyTorch version on the card (K1, K2 and K3 also at the edges of
their shared-memory staging: every lattice type, both neighbourhoods, four
tiles, partial blocks of tiles, K other than th * tw, fused shifts; K4
over lattice types, label counts on both sides of its register bins,
labels outside 0..S, ragged lengths and a misaligned view; S1 over
lattice types, neighbourhoods, boundaries and ``drop_conflicts`` on 12 x
12 and 64 x 64, one MCS at 1600 x 1600 and at 3200 x 3200, and against
``batched.run_proposals`` at 3200 x 3200), reproduces
``tests/golden/fused_trajectory.json`` and
``tests/golden/reference_trajectory.json`` through ``simulate`` on the
card, and drives the port's paths through the entry points a user calls,
each with the launch counts set to 0 just before it and read just after:

* park3 at 3200 x 3200 on the ``pallas_fused`` engine, ``k_mcs`` 1 and 10
  (K1, K2, K4), and again with every observable on;
* park3 at 3200 x 3200 on the stream-fed ``pallas`` engine with its
  declared observables (K3, K4, no ``torch.roll``), held to the plain
  ``sublattice`` engine;
* bulk Philox words and uniforms, ``ops.philox_bits``/``philox_uniform``
  (K5);
* park3 at 3200 x 3200 on the default ``batched`` engine, observables off
  and declared (K4 only), held to the CPU at 800 x 800;
* park3 at 3200 x 3200 on the sequential ``reference`` engine for three
  MCS (S1 once per MCS, K4);
* park3 at 3200 x 3200 on the domain-decomposed ``sharded`` engine over a
  (2, 2) mesh of four ``cuda:0`` entries: ``local_kernel='fused'`` (one
  launch of K1's table form per MCS for the four blocks and one K4s launch
  per count, no ``torch.roll``) held to ``pallas_fused``, again on a (1,
  1) mesh with ``k_mcs`` 10 (K2); ``'pallas'`` with park3's declared
  observables (K3's table form, K4s) held to ``pallas``; and ``'jnp'`` at
  256 x 256 held to ``'pallas'``.
  ``density_counts_sharded`` (K4s: one grouped launch over the card's
  blocks) is held to the plain count of the whole lattice.
* IID trials through ``trials.run_trials``, one launch per kernel and MCS
  for every trial: park3 at 3200 x 3200 on ``pallas_fused`` (16 trials
  beside 1, ``k_mcs`` 1 and 10: K1 or K2 and K4 over the trials), every
  trial held to ``simulate`` from its lattice and run key; park3 at 3200 x
  3200 on ``pallas`` (8 trials with park3's observables: K3 and K4 over the
  trials), held to 8 single runs; Park's eight species
  (``probabilistic``), 64 trials at 100 x 100 on the default ``batched``
  engine, its device launches per MCS counted at 8 and 64 trials and its
  first trials held to the CPU; ``tests/golden/trial_result.json`` on
  ``sublattice`` and ``pallas``. The trial forms of K1-K4 are held to
  their plain versions at the staging edges with 1, 3 and 16 trials.
* The composed pod x grid engine ``sharded_pod`` through ``run_trials``,
  park3 at 3200 x 3200: (a) ``'fused'``, 16 trials on a (2, 2, 2) mesh of
  eight ``cuda:0`` entries, one launch of K1's table form and one of K4s
  per trial per MCS for all trials, no ``torch.roll``, every trial held to
  ``pallas_fused``'s; (b) ``'fused'`` on (4, 1, 1) at ``k_mcs`` 10 (K2's
  trial form per pod group) held to the same; (c) ``'pallas'``, 8 trials
  with park3's observables (K3's table form) held to ``pallas``'s, rows
  included; (d) ``'jnp'`` at 256 x 256 held to ``'pallas'``; (e) the
  default mesh (every card on the pod axis); (f) ``simulate`` held to
  ``sharded``; (g) the table forms of K1 and K3 and K4s per trial held to
  their plain versions at the staging edges (1, 4 and 8 runs of 1, 3 and
  16 trials, halos on both, one and no axes, shifts 0 and tile - 1) and
  at (a)'s shapes.
* The user's entry points at 3200 x 3200: ``[cli]`` starts ``python -m
  repro_torch.launch.escg_run`` as a subprocess (park3 on
  ``pallas_fused``): (a) 20 MCS with ``--save``, its ``state.npz`` lattice
  and ``densities.csv`` held to ``simulate`` in this process, one K1 and
  one K4 launch per MCS; (b) ``--resume`` to 30 MCS held to ``simulate``
  from the saved lattice and ``fold_in(PRNGKey(0), 20)``; (c) (a) with
  ``--kMcs 10`` (K2) writing (a)'s files; (d) ``--trials 8`` whose
  ``trials.json`` equals ``run_trials``; (e) the README matrices'
  ``--check``. ``[serve]`` runs a ``ScenarioServer`` on ``cuda:0``: three
  park3 ``pallas_fused`` requests (4, 4 and 8 trials; 10, 20 and 20 MCS)
  packed into one batch of 16 trials with one K1 trial-form and one K4
  per-trial launch per MCS, each response held to its direct
  ``run_trials``; a second wave answered from the cache with no engine
  built; the batch's set-up, MCS and host copies timed apart on the
  cached entry; one ``sharded_pod`` request on a (2, 2, 2) mesh of
  ``cuda:0``;
  ``python -m repro_torch.launch.serve`` on the committed smoke trace with
  ``--check``; and one request through the HTTP adapter on 127.0.0.1.
* The LM appendix (DESIGN.md §9; no TPU kernel lies on its path, so it
  adds no kernel), the dense family: ``[lm/serve]`` granite-3-8b at full
  width with 8 of its 40 layers (bfloat16), a prefill of 2 x 4095 tokens
  and one ``decode_step`` against a 4096-token prefill (timed in
  bfloat16; held within 2e-2 with float32 compute on the same weights);
  ``[lm/train]`` six AdamW steps of 2 x 4096 ``SyntheticTokens`` under
  the reference's ``cosine_schedule`` (ms per step, tokens/s, the
  model-FLOPs share, peak memory; the loss finite and step 1's batch's
  loss lower after them); ``[lm/restart]`` the
  ``FaultTolerantLoop`` at the reduced size with a failure at step 5,
  equal bit for bit to a failure-free run, and ``python -m
  repro_torch.launch.train`` as a process, then with ``--resume``;
  ``[ckpt]`` park3's 3200 x 3200 lattice after 10 MCS of
  ``sharded``/``fused`` on (2, 2) of ``cuda:0`` saved as a
  ``ShardedLattice`` with its key, restored onto (4, 1) and whole, K4s
  on the restored mesh equal to the saved counts, bfloat16 and int32
  leaves bit for bit.
* The LM appendix's other families at full width, each model freed
  before the next: ``[lm/moe]`` grok-1-314b with 2 of its 64 layers
  (prefill 2 x 4095, decode; layer 0's share of dropped choices and what
  sets it; decode against a prefill with float32 compute and ``moe_cf`` 8
  at 1 x 1024, held to 1e-3, as every family's float32 check is) and
  kimi-k2-1t-a32b with 1 of 61 (prefill 1 x 4096, decode; ``moe_layer``
  on 64 tokens held to a float32 loop over the kept choices through the
  experts' own slices); ``[lm/ssm]`` falcon-mamba-7b serving at 16 of
  its 64 layers (prefill 2 x 4096, decode; float32 decode against a
  prefill at 2 layers) and training at 2 (six AdamW steps of 2 x 4096,
  every grad norm finite, step 1's batch's loss lower after them; ms per
  step, tokens/s, the model-FLOPs share, peak memory, one step's device
  launches under the profiler); ``[lm/hybrid]`` zamba2-7b at 12 of 81
  layers (two shared-attention applications) at its own ``ssm_chunk`` of
  128, the same train checks, prefill, decode and the float32 check; and
  ``[lm/encdec]`` whisper-small whole, the same at 2 x 4096 decoder
  tokens over 1500 frames.
* The LM appendix's multi-device layer on the one card: ``[lm/mesh]``
  phase 29's six AdamW steps on a (1, 1) ``data x model`` mesh of
  ``cuda:0`` in a world of one under NCCL, the state placed as DTensors
  by the sharding rules and ``activation_sharding`` on, held bit for bit
  to phase 29's losses, grad norms and per-leaf checksums of the final
  params (a failure, naming the first leaf that differs), with the
  dry-run of the same cell's roofline bound and peak bytes beside the
  measured step and memory; ``[lm/pipeline]`` ``pipeline_apply`` of
  granite-3-8b's 8 decoder layers at full width in float32, 2 per stage
  over four ``cuda:0`` stages, a batch of 4 x 4096 at ``n_micro`` 4 and
  1, bit for bit the sequential composition per micro-batch and within
  1e-5 of the whole batch.

It times every kernel and prints one JSON line with the kernel table and,
last, ``{"ok": true, "device": ...}``. Any failure raises and exits
non-zero; without a CUDA card, or without the repository around it, it
exits non-zero before printing a result. It imports nothing of JAX.
"""
import contextlib
import dataclasses
import hashlib
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import urllib.request

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "golden", "fused_trajectory.json")
REF_GOLDEN = os.path.join(HERE, "tests", "golden",
                          "reference_trajectory.json")

SIDE, TILE, MCS, CHUNK = 3200, (8, 32), 200, 100
K_MCS = 10
# each kernel's ms per launch before its redesign (PERF.md's kernel table;
# S1's, one MCS at 3200 x 3200, from kernels/probe/s1_probe.cu; an NVIDIA
# H100 80GB HBM3 at 700 W), printed beside this run's
PREVIOUS_MS = {"K1": 0.5462, "K2": 7.1767, "K3": 0.9684, "K4": 0.0273,
               "K4s": 0.0822, "S1": 5762.722}
# K1's and K2's ms per launch after their redesign (the same table)
REDESIGNED_MS = {"K1": 0.1289, "K2": 1.1594}
# the edge cases' lattice: 900 to 3,600 tiles for the tiles below, never a
# whole number of the 32 tiles a block stages
EDGE_SIDE = 480
EDGE_TILES = ((8, 8), (8, 16), (8, 32), (16, 32))
# K4's cases: label counts S on both sides of its register bins (16
# labels), and lengths with ragged heads and tails
K4_SPECIES = (3, 5, 15, 16, 40)
K4_LENGTHS = (0, 1, 31, 4099)
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
# K3 per elementary update: 4 proposal loads, the cell's row and column 8,
# neighbour offsets and addresses 6, 2 cell loads, 2 dominance loads and 2
# stores 6, the rule 12, loop control 2.
OPS_PER_STREAM_UPDATE = 38
# K4 per cell: 1 load, the label match and its leader 3, 2 range compares.
OPS_PER_COUNTED_CELL = 6
# K5 per counter: 10 rounds of 2 wide multiplies, 2 three-input xors and 2
# key additions = 60, the counter and the store 2.
OPS_PER_COUNTER = 62
K5_WORDS = 1 << 26
# S1's cases: a 12 x 12 (the reference golden's) and a 64 x 64 lattice with
# a whole and a ragged number of its 256-step windows and 4,096 proposals;
# then one MCS at 1600 x 1600 and at 3200 x 3200 (10.24 M steps) in
# 1,024-step windows, held to the host loop
S1_SIDES, S1_PROPS = (12, 64), (4096, 4097)
# S1's ns per step before its redesign (one thread walking the stream; an
# NVIDIA H100 80GB HBM3 at 700 W): 1600 x 1600 and the batched window
# with drop_conflicts at 3200 x 3200 from PERF.md's kernel table;
# 12 x 12, 64 x 64 and one MCS at 3200 x 3200 from
# src/repro_torch/kernels/probe/s1_probe.cu
S1_PREVIOUS_NS = {12: 342.96, 64: 342.6, 1600: 470.6, 3200: 562.77,
                  "window": 729.7}
# the reference path: park3 at 3200 x 3200 for this many MCS; S1 alone for
# one MCS at these sides
REF_SIDE, REF_MCS = 3200, 3
S1_MCS_SIDES = (1600, REF_SIDE)
# S1 per step: 4 proposal fields and the two cells it reads and writes
OPS_PER_SCAN_STEP = 40
# the batched path held to the CPU at this side for this many MCS
BATCHED_CPU_SIDE, BATCHED_CPU_MCS = 800, 3
ALL_OBS = ("densities", "interface_length", "cluster_size", "snapshot")
# the sharded engine's runs: a (2, 2) mesh of one card's entries, 50 MCS
# in chunks of 25 at 3200 x 3200 (each beside its single-device twin), and
# the plain sweep at 256 x 256 for 3 MCS
SH_GRID, SH_MCS, SH_CHUNK = (2, 2), 50, 25
JNP_SIDE, JNP_MCS = 256, 3
# the trial driver's runs at 3200 x 3200: park3 on pallas_fused for 20 MCS
# in chunks of 10 (16 trials beside 1) and on pallas for 5 MCS (8 trials)
TR_FUSED_N, TR_MCS, TR_CHUNK = 16, 20, 10
TR_PALLAS_N, TR_PALLAS_MCS = 8, 5
# trials per launch at the staging edges, case by case
TR_EDGE_NS = (16, 1, 3)
# Park's eight species, the README's trial example cut from L^2 = 10,000 MCS:
# 64 trials at 100 x 100 on the default engine, 100 MCS in chunks of 50;
# its launches per MCS counted over PARK_COUNT_MCS at 8 and at 64 trials;
# its first PARK_CPU_N trials held to the CPU for PARK_CPU_MCS
PARK_SIDE, PARK_N, PARK_MCS, PARK_CHUNK = 100, 64, 100, 50
PARK_COUNT_MCS, PARK_CPU_N, PARK_CPU_MCS = 4, 4, 3
TRIAL_GOLDEN = os.path.join(HERE, "tests", "golden", "trial_result.json")
# the composed engine's runs at 3200 x 3200: 16 trials on a (2, 2, 2) mesh
# of one card's entries for 10 MCS (fused), 8 trials for 3 MCS (pallas);
# its table forms at the staging's edges on blocks of 240 x 224 with 1, 4
# and 8 runs
POD_MESH, POD_N, POD_MCS = (2, 2, 2), 16, 10
POD_PALLAS_N, POD_PALLAS_MCS = 8, 3
POD_EDGE_BLOCK, POD_EDGE_RUNS = (240, 224), (1, 4, 8)
# the entry points at SIDE: the CLI's runs (20 MCS in chunks of 10, a
# resume of 10 more, 8 trials of 10 MCS), and the server's three
# pallas_fused requests (seed, trials, MCS) that pack into one batch of 16,
# then one sharded_pod request of 8 trials for 5 MCS
CLI_MCS, CLI_CHUNK, CLI_RESUME, CLI_TRIALS, CLI_TRIAL_MCS = 20, 10, 10, 8, 10
SRV_REQS, SRV_CHUNK = ((1, 4, 10), (2, 4, 20), (3, 8, 20)), 10
SRV_POD_N, SRV_POD_MCS = 8, 5
# the LM appendix (DESIGN.md §9): granite-3-8b at full width with 8 of its
# 40 layers, bfloat16; prefill 2 x 4095 tokens then one decode step against
# a 4096-token prefill (four 1024-token kv chunks), decode timed over
# LM_DECODES calls; AdamW for LM_STEPS steps of 2 x 4096 tokens (train_4k's
# sequence, its batch of 256 cut to 2) under the reference's
# cosine_schedule defaults; the restart check at the reduced
# size (the launcher's default 8 x 256 batch), a failure at RESTART_FAIL;
# the H100 SXM's dense bfloat16 peak for the model-FLOPs share
LM_ARCH, LM_LAYERS, LM_SEQ, LM_BATCH, LM_STEPS = "granite-3-8b", 8, 4096, 2, 6
LM_DECODES, H100_BF16_FLOPS = 8, 989.4e12
# the LM appendix's other families at full width (phases 32-35): grok-1
# with GROK_LAYERS of its 64 layers and kimi-k2 with KIMI_LAYERS of 61,
# serving only (their weights, grads and optimizer state at full width do
# not fit one card at any depth); the float32 cache checks at
# LM_CHECK_SEQ tokens (grok-1 1 x LM_CHECK_SEQ with moe_cf 8, no drops; the
# others LM_BATCH x LM_CHECK_SEQ): the (LM_CHECK_SEQ - 1)-token prefill is
# odd, so the reference's chunk rule halves the SSM chunk to 1 there, and
# Mamba-2 then holds every token's (heads, state, head_dim) state (3.75 GB
# at zamba2-7b's widths, 15 GB at 4095 tokens); kimi-k2's moe_layer held on
# MOE_CHECK_TOKENS tokens to a loop over the kept choices; falcon-mamba-7b
# serving at MAMBA_SERVE_LAYERS of 64 and training at MAMBA_TRAIN_LAYERS
# (cut from 64 and 8 to keep the script under its time with phases
# 36-37: its training step is host-bound, about 6 s at 4 layers);
# zamba2-7b at ZAMBA_LAYERS of 81 (two shared-attention applications);
# whisper-small whole. Prefills and steps of LM_BATCH x LM_SEQ tokens
# (kimi-k2 1 x LM_SEQ), LM_STEPS AdamW steps each.
GROK_LAYERS, KIMI_LAYERS, LM_CHECK_SEQ, MOE_CHECK_TOKENS = 2, 1, 1024, 64
MAMBA_SERVE_LAYERS, MAMBA_TRAIN_LAYERS, ZAMBA_LAYERS = 16, 2, 12
RESTART_STEPS, RESTART_EVERY, RESTART_FAIL, RESTART_RESUME = 8, 2, 5, 12
# the pipeline of phase 37: granite-3-8b's LM_LAYERS decoder layers over
# PIPE_STAGES stages of cuda:0, a float32 batch of PIPE_BATCH x LM_SEQ
PIPE_STAGES, PIPE_BATCH = 4, 4
# a sharded_fused lattice after CKPT_MCS MCS at SIDE, saved on SH_GRID and
# restored onto CKPT_GRID and whole
CKPT_MCS, CKPT_GRID = 10, (4, 1)


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


def profiled_ms(torch, fn, n, kernel):
    """Device ms per launch of the kernels whose name holds ``kernel``,
    from a ``torch.profiler`` trace of ``n`` calls (one launch each) after
    one warm-up call: their summed device time over the launches the trace
    holds, as text; "not measured" and the reason if the trace holds no
    device time for them or another number of launches than ``n``."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us, count = 0.0, 0
    for evt in prof.key_averages():
        if (evt.device_type == torch.autograd.DeviceType.CUDA
                and kernel in evt.key):
            us += float(getattr(evt, "self_device_time_total", 0.0)
                        or getattr(evt, "self_cuda_time_total", 0.0))
            count += evt.count
    if us <= 0:
        return "not measured (the profiler saw no device time)"
    if count != n:
        return f"not measured (the trace holds {count} of the {n} launches)"
    return f"{us / count / 1e3:.4f} ms"


def once_ms(torch, fn):
    """(ms, result) of one call of ``fn``, synchronised (for the slow
    plain versions)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def max_err(torch, a, b):
    return float((a.long() - b.long()).abs().max()) if a.numel() else 0.0


def words(torch, t):
    """uint32 words as int64 (PyTorch computes little on uint32)."""
    return t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def edge_cases(torch):
    """K1/K2 cases at the staging's edges: (dtype, neighbourhood, tile,
    proposals per tile, tile_offset, grid_tiles_w, steps, shifts). Every
    lattice type meets every tile; K is th * tw or not; steps are 1, 3 and
    10; shifts include 0, 1, H - 1 and W - 1."""
    h = w = EDGE_SIDE
    pattern = [(0, 0), (1, 1), (h - 1, w - 1), (h - 1, 0), (0, w - 1),
               (1, w - 1), (h - 1, 1), (0, 1), (1, 0), (5, 9)]
    cases = []
    for i, (dtype, tile) in enumerate(itertools.product(
            (torch.int8, torch.int16, torch.int32), EDGE_TILES)):
        steps = (1, 3, 10)[i % 3]
        cases.append((dtype, 4 if i % 2 == 0 else 8, tile,
                      tile[0] * tile[1] - (7 if i % 3 == 0 else 0),
                      (3, 7) if i % 4 == 1 else (0, 0),
                      111 if i % 4 == 1 else None, steps,
                      (pattern[i % 10:] + pattern[:i % 10])[:steps]))
    return cases


def stream_edge_cases(torch, chunk):
    """K3 cases at the staging's edges: (dtype, neighbourhood, tile,
    proposals per tile, shift). Every lattice type meets every tile and
    both neighbourhoods; K is th * tw, th * tw - 7 and less than one chunk
    of the proposal stream; shifts include 0, 1, H - 1 and W - 1."""
    h = w = EDGE_SIDE
    pattern = [(0, 0), (1, 1), (h - 1, w - 1), (h - 1, 0), (0, w - 1),
               (1, w - 1), (h - 1, 1)]
    cases = []
    for i, (dtype, tile, nbhd) in enumerate(itertools.product(
            (torch.int8, torch.int16, torch.int32), EDGE_TILES, (4, 8))):
        for j, k in enumerate((tile[0] * tile[1], tile[0] * tile[1] - 7,
                               chunk - 3)):
            cases.append((dtype, nbhd, tile, k,
                          pattern[(3 * i + j) % len(pattern)]))
    return cases


@contextlib.contextmanager
def counted_rolls(torch, rolls, key):
    """Count the ``torch.roll`` calls made while the block runs into
    ``rolls[key]``."""
    real = torch.roll
    rolls[key] = 0

    def counted(*args, **kwargs):
        rolls[key] += 1
        return real(*args, **kwargs)
    torch.roll = counted
    try:
        yield
    finally:
        torch.roll = real


def lm_phases(torch, np, dev, card, park3, mesh4):
    """The LM appendix's paths on the card (phases 28-31): ``[lm/serve]``,
    ``[lm/train]``, ``[lm/restart]`` and ``[ckpt]``. Every figure is
    printed on its own line beside the card. Returns what phase 29 kept
    for phase 36: its losses, grad norms, steady step ms, peak memory,
    launches per step and a checksum per final param leaf."""
    from repro_torch.configs import ARCHS as LM_ARCHS
    from repro_torch.configs import SHAPES, ShapeConfig
    from repro_torch.core import engines, lattice, sharded, threefry
    from repro_torch.core.scenarios import EngineConfig, RunConfig, compose
    from repro_torch.core.simulation import build_chunk_fn, simulate
    from repro_torch.data import batch_for_model
    from repro_torch.models import build_model
    from repro_torch.models.spec import tree_leaves
    from repro_torch.optim import cosine_schedule
    from repro_torch.parallel.sharding import LatticeMesh
    from repro_torch.runtime import train_lib
    from repro_torch.runtime.checkpoint import CheckpointManager
    from repro_torch.runtime.fault import FaultTolerantLoop

    # ---- 28. [lm/serve] prefill and decode at full width ----
    cfg = LM_ARCHS[LM_ARCH].replace(n_layers=LM_LAYERS)
    check((cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim, cfg.d_ff,
           cfg.vocab_padded, cfg.param_dtype, cfg.compute_dtype)
          == (4096, 32, 8, 128, 12800, 49408, "bfloat16", "bfloat16"),
          f"[lm] {LM_ARCH} is not at its full width: {cfg}")
    model = build_model(cfg)
    n_params = model.n_params()
    t_phase = time.perf_counter()
    init_ms, params = once_ms(torch, lambda: model.init(threefry.PRNGKey(0),
                                                       dev))
    tokens = batch_for_model(
        model, ShapeConfig("prefill_4k", LM_SEQ, LM_BATCH, "prefill"), 0, 0,
        device=dev)["tokens"]
    prefill = train_lib.make_prefill_step(model, LM_SEQ)
    decode = train_lib.make_decode_step(model)
    prompt, nxt = {"tokens": tokens[:, :-1]}, {"tokens": tokens[:, -1]}
    first_ms, _ = once_ms(torch, lambda: prefill(params, prompt))
    prefill_ms, (last, cache) = once_ms(torch, lambda: prefill(params,
                                                               prompt))
    logits, cache2 = decode(params, cache, nxt)
    decode_ms = event_ms(torch, lambda: decode(params, cache, nxt),
                         LM_DECODES)
    full_ms, (want, _) = once_ms(torch, lambda: prefill(
        params, {"tokens": tokens}))
    got, want = logits.float(), want.float()
    err_bf16 = float((got - want).abs().max())
    check(got.shape == (LM_BATCH, cfg.vocab_padded)
          and bool(torch.isfinite(got[:, :cfg.vocab]).all())
          and bool(torch.isfinite(last.float()[:, :cfg.vocab]).all())
          and int(cache["len"]) == LM_SEQ - 1
          and int(cache2["len"]) == LM_SEQ
          and tuple(cache2["k"].shape) == (LM_LAYERS, LM_BATCH, LM_SEQ,
                                           cfg.n_kv, cfg.head_dim),
          "[lm/serve] the logits or the cache have the wrong shape, length "
          "or values")
    # the cache check at the reference test's tolerance: the same bfloat16
    # weights with float32 compute. In bfloat16, cuBLAS rounds a product
    # of M = 2 rows and one of M = 8192 rows to neighbouring bfloat16s now
    # and then, and 8 layers of 4096 widen that to a few hundredths.
    m32 = build_model(cfg.replace(compute_dtype="float32"))
    pre32 = train_lib.make_prefill_step(m32, LM_SEQ)
    _, c32 = pre32(params, prompt)
    got32, _ = train_lib.make_decode_step(m32)(params, c32, nxt)
    want32, _ = pre32(params, {"tokens": tokens})
    err = float((got32 - want32).abs().max())
    check(bool(((got32 - want32).abs() <= 2e-2 + 2e-2 * want32.abs())
               .all()),
          f"[lm/serve] decode after a {LM_SEQ - 1}-token prefill differs "
          f"from a {LM_SEQ}-token prefill beyond 2e-2 (float32 compute): "
          f"max |err| {err}")
    print(f"[lm/serve] {LM_ARCH} at full width, {LM_LAYERS} of 40 layers "
          f"({n_params:,} params, bfloat16), init {init_ms / 1e3:.2f} s; "
          f"prefill {LM_BATCH} x {LM_SEQ - 1} tokens {prefill_ms:.1f} ms "
          f"(first call {first_ms:.1f} ms), decode {decode_ms:.2f} ms per "
          f"token (batch {LM_BATCH}, cache {LM_SEQ}, mean of {LM_DECODES}); "
          f"decode logits against a {LM_SEQ}-token prefill ({full_ms:.1f} "
          f"ms): max |err| {err_bf16:.4g} in bfloat16, {err:.4g} with "
          f"float32 compute (held to 2e-2); {card}")
    del params, cache, cache2, logits, last, got, want, c32, got32, want32

    # ---- 29. [lm/train] AdamW steps at full width ----
    check(LM_SEQ == SHAPES["train_4k"].seq_len, "[lm/train] LM_SEQ is not "
          "train_4k's sequence")
    shape = ShapeConfig("train_4k", LM_SEQ, LM_BATCH, "train")
    torch.cuda.reset_peak_memory_stats()
    state = train_lib.init_state(model, threefry.PRNGKey(0), device=dev)
    # the reference's schedule as it stands (peak 3e-4, 100 warmup steps):
    # AdamW at 3e-4 from the first step moves each weight by 3e-4 and every
    # layer's output by O(1) at this width, and the loss climbs
    step_fn = train_lib.make_train_step(model, schedule=cosine_schedule())
    first = batch_for_model(model, shape, 0, 0, device=dev)
    step_s, losses, lrs, norms = [], [], [], []
    for s in range(LM_STEPS):
        batch = batch_for_model(model, shape, s, 0, device=dev)
        ms, (state, met) = once_ms(torch, lambda: step_fn(state, batch))
        step_s.append(ms / 1e3)
        losses.append(float(met["loss"]))
        lrs.append(float(met["lr"]))
        norms.append(float(met["grad_norm"]))
    kept_params = state["params"]
    with torch.no_grad():
        after = float(model.loss(state["params"], first)[0])
    peak = torch.cuda.max_memory_allocated()
    steady = sum(step_s[1:]) / (LM_STEPS - 1)
    n_tok = LM_BATCH * shape.seq_len
    mfu = 6 * n_params * n_tok / (steady * H100_BF16_FLOPS)
    check(all(np.isfinite(losses)) and np.isfinite(after)
          and int(state["step"]) == LM_STEPS,
          f"[lm/train] losses {losses}, step {int(state['step'])}")
    check(after < losses[0], f"[lm/train] the loss of step 1's batch did not "
          f"fall over {LM_STEPS} steps: {losses[0]} -> {after}")
    train_s = time.perf_counter() - t_phase
    busy_ms, gemm_share, top, step_launches = lm_step_profile(
        torch, lambda: step_fn(state, batch))
    print(f"[lm/train] {LM_ARCH} {LM_LAYERS} layers, AdamW, batch "
          f"{LM_BATCH} x {shape.seq_len} from SyntheticTokens, {LM_STEPS} "
          f"steps (lr {lrs[0]:.2g} to {lrs[-1]:.2g}, the reference's "
          f"cosine_schedule defaults): losses "
          f"{[round(x, 4) for x in losses]}; step 1's batch "
          f"{losses[0]:.4f} -> {after:.4f} after step {LM_STEPS}; "
          f"{steady * 1e3:.1f} ms per step after the first (first "
          f"{step_s[0] * 1e3:.1f}), {n_tok / steady:,.0f} tokens/s, "
          f"model-FLOPs share {mfu:.4f} of {H100_BF16_FLOPS / 1e12} TFLOP/s"
          f" (6 N tokens, N = {n_params:,}), max_memory_allocated "
          f"{peak / 2 ** 30:.2f} GiB; phases 28-29 {train_s:.1f} s; {card}")
    print(f"[lm/train] one more step under torch.profiler: {step_launches} "
          f"device launches, device busy {busy_ms}, cuBLAS products "
          f"{gemm_share} of it; the largest kernels by device ms: {top}")
    # what phase 36 holds its sharded run to (the extra profiled step is
    # not part of the six)
    kept = {"losses": losses, "norms": norms, "step_ms": steady * 1e3,
            "peak": peak, "launches": step_launches,
            "sums": leaf_sums(torch, kept_params)}
    del state, met, batch, first, kept_params

    # ---- 30. [lm/restart] the fault-tolerant loop at the reduced size ----
    rmodel = build_model(LM_ARCHS[LM_ARCH].reduced())
    rshape = ShapeConfig("cli", 256, 8, "train")
    rstep = train_lib.make_train_step(rmodel)
    work = tempfile.mkdtemp(prefix="chip_smoke_lm_")

    def rrun(name, fail_at):
        loop = FaultTolerantLoop(
            rstep, CheckpointManager(os.path.join(work, name), device=dev),
            ckpt_every=RESTART_EVERY)
        fails = set() if fail_at is None else {fail_at}
        st = train_lib.init_state(rmodel, threefry.PRNGKey(0), device=dev)
        out, end = loop.run(
            st, lambda s: batch_for_model(rmodel, rshape, s, 0, device=dev),
            RESTART_STEPS,
            inject_failure=lambda s: s in fails and not fails.discard(s))
        return out, end, loop.restarts
    t0 = time.perf_counter()
    clean, end0, r0 = rrun("clean", None)
    again, end1, r1 = rrun("failed", RESTART_FAIL)
    loop_s = time.perf_counter() - t0
    leaves = list(zip(tree_leaves(clean), tree_leaves(again)))
    check((end0, r0, end1, r1) == (RESTART_STEPS, 0, RESTART_STEPS, 1)
          and int(again["step"]) == RESTART_STEPS,
          f"[lm/restart] ends {end0}, {end1}, restarts {r0}, {r1}")
    check(all(a.dtype == b.dtype and torch.equal(a, b) for a, b in leaves),
          "[lm/restart] the restarted run's state differs from the "
          "failure-free run's")
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.join(HERE, "src") + os.pathsep
                         + env.get("PYTHONPATH", ""))
    cli = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           LM_ARCH, "--reduced", "--ckpt_dir", os.path.join(work, "cli"),
           "--ckpt_every", str(RESTART_EVERY), "--log_every", "4"]
    walls = []
    for args, want_text in (
            (["--steps", str(RESTART_STEPS)],
             f"steps 0->{RESTART_STEPS}"),
            (["--steps", str(RESTART_RESUME), "--resume"],
             f"steps {RESTART_STEPS}->{RESTART_RESUME}")):
        t1 = time.perf_counter()
        out = subprocess.run(cli + args, capture_output=True, text=True,
                             timeout=600, env=env, cwd=HERE)
        walls.append(time.perf_counter() - t1)
        check(out.returncode == 0 and want_text in out.stdout
              and "device=cuda" in out.stdout,
              f"[lm/restart] launch.train {args} exited {out.returncode}:\n"
              f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    check(CheckpointManager(os.path.join(work, "cli"), device=dev)
          .latest_step() == RESTART_RESUME,
          "[lm/restart] the resumed launcher left no checkpoint at its end")
    shutil.rmtree(work, ignore_errors=True)
    print(f"[lm/restart] {LM_ARCH} reduced ({rmodel.n_params():,} params), "
          f"{RESTART_STEPS} steps of 8 x 256, a checkpoint every "
          f"{RESTART_EVERY}, a failure at step {RESTART_FAIL}: ends at step "
          f"{end1} after 1 restart, every one of {len(leaves)} state leaves "
          f"equal to the failure-free run's bit for bit ({loop_s:.2f} s for "
          f"both runs); python -m repro_torch.launch.train {walls[0]:.1f} s "
          f"to step {RESTART_STEPS}, then --resume to {RESTART_RESUME} "
          f"{walls[1]:.1f} s; {card}")

    # ---- 31. [ckpt] a decomposed lattice saved and restored elsewhere ----
    p_ck = compose(park3, EngineConfig(engine="sharded", tile=TILE,
                                       shard_grid=SH_GRID,
                                       local_kernel="fused"),
                   RunConfig(length=SIDE, height=SIDE, mcs=CKPT_MCS,
                             chunk_mcs=CKPT_MCS, observables=()))
    eng = engines.build(p_ck, park3.dominance(), mesh4)
    key, k0 = threefry.split(threefry.PRNGKey(p_ck.seed))
    lat = eng.place(lattice.init_grid(k0, SIDE, SIDE, p_ck.species,
                                      p_ck.empty, device=dev,
                                      dtype=getattr(torch, p_ck.cell_dtype)))
    lat, key, cnts, _, _ = build_chunk_fn(p_ck, eng)(lat, key, CKPT_MCS)
    check(isinstance(lat, sharded.ShardedLattice)
          and lat.mesh.shape == SH_GRID,
          f"[ckpt] sharded/fused did not keep a {SH_GRID} ShardedLattice")
    saved = lat.gather()
    twin = simulate(p_ck, park3.dominance(), device=mesh4,
                    stop_on_stasis=False)
    check(np.array_equal(saved.cpu().numpy(), twin.grid),
          "[ckpt] the lattice differs from simulate's after the same MCS")
    words = torch.randint(-2 ** 15, 2 ** 15, (4096, 128), dtype=torch.int32,
                          generator=torch.Generator().manual_seed(0))
    half = words.to(torch.int16).view(torch.bfloat16).to(dev)
    ints = words.to(dev)
    work = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    cm = CheckpointManager(work, device=dev)
    save_ms, _ = once_ms(torch, lambda: cm.save(
        CKPT_MCS, {"lattice": lat, "key": key, "half": half, "ints": ints}))
    mesh41 = LatticeMesh(tuple((torch.device("cuda", 0),)
                               for _ in range(CKPT_GRID[0])))
    restore_ms, (step, got) = once_ms(
        torch, lambda: cm.restore(shardings={"lattice": mesh41}))
    whole_ms, (_, whole) = once_ms(torch, lambda: cm.restore())
    nbytes = saved.numel() * saved.element_size()
    counts = sharded.sharded_counts(got["lattice"], p_ck.species)
    check(step == CKPT_MCS and got["lattice"].mesh.shape == CKPT_GRID
          and torch.equal(got["lattice"].gather(), saved)
          and whole["lattice"].device.type == "cuda"
          and torch.equal(whole["lattice"], saved)
          and torch.equal(got["key"], key.to(dev))
          and torch.equal(counts.cpu(), cnts[-1].cpu().to(counts.dtype)),
          "[ckpt] the restored lattice, its key or its K4s counts differ "
          "from the saved run's")
    check(got["half"].dtype == torch.bfloat16 and got["half"].is_cuda
          and torch.equal(got["half"].view(torch.int16).cpu(),
                          words.to(torch.int16))
          and torch.equal(got["ints"], ints),
          "[ckpt] the bfloat16 or int32 leaf did not round-trip")
    shutil.rmtree(work, ignore_errors=True)
    print(f"[ckpt] park3 {SIDE}x{SIDE} after {CKPT_MCS} MCS of "
          f"sharded/fused on {SH_GRID} of cuda:0 ({nbytes / 1e6:.2f} MB, "
          f"equal to simulate's): saved as a ShardedLattice leaf with its "
          f"key, a bfloat16 and an int32 leaf in {save_ms / 1e3:.3f} s; "
          f"restored onto {CKPT_GRID} of cuda:0 in {restore_ms / 1e3:.3f} s "
          f"and whole in {whole_ms / 1e3:.3f} s, both equal to the saved "
          f"lattice, K4s on {CKPT_GRID} equal to the saved counts "
          f"{counts.tolist()}; the bfloat16 and int32 leaves bit for bit; "
          f"{card}")
    return kept


def lm_family_phases(torch, np, dev, card, park3, mesh4):
    """The LM appendix's other families on the card (phases 32-35):
    ``[lm/moe]`` (grok-1 and kimi-k2 serving), ``[lm/ssm]`` (falcon-mamba
    serving and training), ``[lm/hybrid]`` (zamba2) and ``[lm/encdec]``
    (whisper-small), each at full width, its model freed before the next.
    Every figure is printed on its own line beside the card."""
    from repro_torch.configs import ARCHS as LM_ARCHS
    from repro_torch.configs import ShapeConfig
    from repro_torch.core import threefry
    from repro_torch.data import batch_for_model
    from repro_torch.models import build_model, common, moe, transformer
    from repro_torch.models.spec import torch_dtype, tree_map
    from repro_torch.optim import cosine_schedule
    from repro_torch.runtime import train_lib

    def full_width(name, n_layers, **want):
        cfg = LM_ARCHS[name].replace(n_layers=n_layers)
        got = {k: getattr(cfg, k) for k in want}
        check(got == want and cfg.param_dtype == "bfloat16"
              and cfg.compute_dtype == "bfloat16",
              f"[lm] {name} is not at its full width: {got}")
        return cfg

    def free():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    def inputs(model, seq, n):
        return batch_for_model(model, ShapeConfig("prefill", seq, n,
                                                  "prefill"), 0, 0,
                               device=dev)

    def serve(model, params, n, seq, label):
        """Prefill n x seq tokens under torch.profiler (printed; the first
        call), then timed, then decode the next token against that cache
        (mean of LM_DECODES)."""
        cfg = model.cfg
        full = inputs(model, seq + 1, n)
        prompt = dict(full, tokens=full["tokens"][:, :seq])
        nxt = {"tokens": full["tokens"][:, seq]}
        prefill = train_lib.make_prefill_step(model, seq + 1)
        decode = train_lib.make_decode_step(model)
        busy_ms, gemm_share, top, launches = lm_step_profile(
            torch, lambda: prefill(params, prompt))
        print(f"[{label}] {cfg.name}: one prefill of {n} x {seq} under "
              f"torch.profiler: {launches} device launches, device busy "
              f"{busy_ms}, cuBLAS products {gemm_share} of it; the largest "
              f"kernels by device ms: {top}")
        prefill_ms, (last, cache) = once_ms(torch, lambda: prefill(params,
                                                                   prompt))
        logits, cache2 = decode(params, cache, nxt)
        decode_ms = event_ms(torch, lambda: decode(params, cache, nxt),
                             LM_DECODES)
        specs = model.cache_specs(n, seq + 1)
        check(tuple(logits.shape) == (n, cfg.vocab_padded)
              and bool(torch.isfinite(logits.float()[:, :cfg.vocab]).all())
              and bool(torch.isfinite(last.float()[:, :cfg.vocab]).all())
              and int(cache["len"]) == seq and int(cache2["len"]) == seq + 1
              and all(tuple(cache2[k].shape) == specs[k].shape
                      and cache2[k].dtype == torch_dtype(specs[k].dtype)
                      for k in specs),
              f"[lm] {cfg.name}: the logits or the cache have the wrong "
              f"shape, length or values")
        return prefill_ms, decode_ms

    def decode_vs_prefill(cfg32, params, n, seq):
        """Max |err| of a decode after an (seq - 1)-token prefill against a
        seq-token prefill, float32 compute on the bfloat16 weights, held
        to 1e-3 (on the H100 they read 3.5e-06 to 2.5e-05; PERF.md §6)."""
        free()
        m32 = build_model(cfg32)
        full = inputs(m32, seq, n)
        pre = train_lib.make_prefill_step(m32, seq)
        _, c = pre(params, dict(full, tokens=full["tokens"][:, :-1]))
        got, _ = train_lib.make_decode_step(m32)(
            params, c, {"tokens": full["tokens"][:, -1]})
        want, _ = pre(params, full)
        err = float((got - want).abs().max())
        check(bool(((got - want).abs() <= 1e-3 + 1e-3 * want.abs()).all()),
              f"[lm] {cfg32.name}: decode after a {seq - 1}-token prefill "
              f"differs from a {seq}-token prefill beyond 1e-3 (float32 "
              f"compute): max |err| {err}")
        return err

    def train(model, label, batch=LM_BATCH, seq=LM_SEQ):
        """LM_STEPS AdamW steps of batch x seq under the reference's
        cosine_schedule, as phase 29: every loss and grad norm finite (a
        finite global norm is every grad finite), the loss of step 1's
        batch lower after them; one more step under torch.profiler."""
        shape = ShapeConfig("train_4k", seq, batch, "train")
        torch.cuda.reset_peak_memory_stats()
        state = train_lib.init_state(model, threefry.PRNGKey(0), device=dev)
        step_fn = train_lib.make_train_step(model,
                                            schedule=cosine_schedule())
        first = batch_for_model(model, shape, 0, 0, device=dev)
        step_s, losses, norms = [], [], []
        for s in range(LM_STEPS):
            b = batch_for_model(model, shape, s, 0, device=dev)
            ms, (state, met) = once_ms(torch, lambda: step_fn(state, b))
            step_s.append(ms / 1e3)
            losses.append(float(met["loss"]))
            norms.append(float(met["grad_norm"]))
        with torch.no_grad():
            after = float(model.loss(state["params"], first)[0])
        peak = torch.cuda.max_memory_allocated()
        check(all(np.isfinite(losses)) and all(np.isfinite(norms))
              and np.isfinite(after) and int(state["step"]) == LM_STEPS,
              f"[{label}] losses {losses}, grad norms {norms}")
        check(after < losses[0], f"[{label}] the loss of step 1's batch "
              f"did not fall over {LM_STEPS} steps: {losses[0]} -> {after}")
        steady = sum(step_s[1:]) / (LM_STEPS - 1)
        n_params = model.n_params()
        n_tok = batch * seq
        mfu = 6 * n_params * n_tok / (steady * H100_BF16_FLOPS)
        busy_ms, gemm_share, top, launches = lm_step_profile(
            torch, lambda: step_fn(state, b))
        print(f"[{label}] {model.cfg.name} {model.cfg.n_layers} layers "
              f"({n_params:,} params), AdamW, batch {batch} x {seq} from "
              f"SyntheticTokens, {LM_STEPS} steps: losses "
              f"{[round(x, 4) for x in losses]}, grad norms "
              f"{[round(x, 4) for x in norms]} (all finite); step 1's batch "
              f"{losses[0]:.4f} -> {after:.4f} after step {LM_STEPS}; "
              f"{steady * 1e3:.1f} ms per step after the first (first "
              f"{step_s[0] * 1e3:.1f}), {n_tok / steady:,.0f} tokens/s, "
              f"model-FLOPs share {mfu:.4f} of {H100_BF16_FLOPS / 1e12} "
              f"TFLOP/s (6 N tokens), max_memory_allocated "
              f"{peak / 2 ** 30:.2f} GiB; {card}")
        print(f"[{label}] one more step under torch.profiler: {launches} "
              f"device launches, device busy {busy_ms}, cuBLAS products "
              f"{gemm_share} of it; the largest kernels by device ms: {top}")

    def moe_routing(cfg, params, tokens):
        """Layer 0's routing in a prefill of ``tokens``
        (``transformer.moe_routing``), its MoE params and input, and what
        sets its drop share: the rms of the embedding and of the attention
        block's output, the mean cosine of two router inputs of one group
        (the embedding's alone beside it), and the share dropped when the
        router sees ``ln2`` of the embedding alone."""
        lp = tree_map(lambda v: v[0], params["layers"])
        with torch.no_grad():
            x, r = transformer.moe_routing(cfg, params, tokens)
            e = transformer.embed_lookup(params["embed"]["tokens"], tokens,
                                         x.dtype)
            h = common.rmsnorm(x, lp["ln2"])
            he = common.rmsnorm(e, lp["ln2"])
            r_e = moe.route_layer(lp["moe"], he, cfg)

            def rms(a):
                return float(a.float().pow(2).mean().sqrt())

            def cosine(a):
                b, g, t = r.topi.shape[:3]
                u = torch.nn.functional.normalize(
                    a.float().reshape(b, g, t, -1), dim=-1)
                return float(((u @ u.transpose(-1, -2)).sum() - b * g * t)
                             / (b * g * t * (t - 1)))

            why = (f"embedding rms {rms(e):.4g}, attention output rms "
                   f"{rms(x - e):.4g}; mean cosine of two router inputs "
                   f"in a group {cosine(h):.4f} (the embedding's alone "
                   f"{cosine(he):.4f}); routed on the embedding alone it "
                   f"would drop {1.0 - float(r_e.keep.float().mean()):.4f}")
        return lp["moe"], h, r, why

    # ---- 32. [lm/moe] grok-1 and kimi-k2 serving at full width ----
    t_phase = time.perf_counter()
    cfg = full_width("grok-1-314b", GROK_LAYERS, d_model=6144, n_heads=48,
                     n_kv=8, head_dim=128, moe_experts=8, moe_topk=2,
                     moe_dff=32768, moe_groups=16, vocab_padded=131072)
    model = build_model(cfg)
    init_ms, params = once_ms(torch, lambda: model.init(threefry.PRNGKey(0),
                                                       dev))
    prefill_ms, decode_ms = serve(model, params, LM_BATCH,
                                  LM_SEQ - 1, "lm/moe")
    _, _, r, why = moe_routing(cfg, params, inputs(
        model, LM_SEQ, LM_BATCH)["tokens"][:, :LM_SEQ - 1])
    grok_drop = 1.0 - float(r.keep.float().mean())
    err = decode_vs_prefill(cfg.replace(compute_dtype="float32",
                                        moe_cf=8.0), params, 1,
                            LM_CHECK_SEQ)
    print(f"[lm/moe] grok-1-314b at full width, {GROK_LAYERS} of 64 layers "
          f"({model.n_params():,} params, {model.n_active_params():,} "
          f"active; bfloat16), init {init_ms / 1e3:.2f} s; prefill "
          f"{LM_BATCH} x {LM_SEQ - 1} tokens {prefill_ms:.1f} ms, decode "
          f"{decode_ms:.2f} ms per token "
          f"(batch {LM_BATCH}, cache {LM_SEQ}, mean of {LM_DECODES}); layer "
          f"0 drops {grok_drop:.4f} of its choices (capacity {r.cap} per "
          f"expert and group of {r.topi.shape[2]}; {why}); float32 "
          f"compute with "
          f"moe_cf 8 at 1 x {LM_CHECK_SEQ}: decode against a prefill max "
          f"|err| {err:.4g} (held to 1e-3); {card}")
    del params, model, r
    free()

    cfg = full_width("kimi-k2-1t-a32b", KIMI_LAYERS, d_model=7168,
                     n_heads=64, n_kv=8, head_dim=112, moe_experts=384,
                     moe_topk=8, moe_dff=2048, moe_groups=16,
                     vocab_padded=163840)
    model = build_model(cfg)
    init_ms, params = once_ms(torch, lambda: model.init(threefry.PRNGKey(0),
                                                       dev))
    prefill_ms, decode_ms = serve(model, params, 1, LM_SEQ,
                                  "lm/moe")
    toks = inputs(model, LM_SEQ + 1, 1)["tokens"][:, :LM_SEQ]
    pm, h, r, why = moe_routing(cfg, params, toks)
    kimi_drop = 1.0 - float(r.keep.float().mean())
    # the dispatch and combine at full width, not through the einsums:
    # moe_layer on MOE_CHECK_TOKENS tokens against sum(gate * FFN_e(x)) over
    # each token's kept choices, from the experts' own slices in float32
    hs = h[:, :MOE_CHECK_TOKENS]
    with torch.no_grad():
        y, _ = moe.moe_layer(pm, hs, cfg)
        rs = moe.route_layer(pm, hs, cfg)
        xs = hs.reshape(-1, cfg.d_model).float()
        e_of = rs.topi.reshape(MOE_CHECK_TOKENS, -1)
        kept = rs.keep.reshape(MOE_CHECK_TOKENS, -1)
        gate = rs.topv.reshape(MOE_CHECK_TOKENS, -1)
        want = torch.zeros_like(xs)
        n_kept = 0
        for e in sorted(set(e_of[kept].tolist())):
            tok, j = torch.nonzero((e_of == e) & kept, as_tuple=True)
            xe = xs[tok]
            he = xe @ pm["wi"][e].float()
            he = he * torch.sigmoid(he) * (xe @ pm["wg"][e].float())
            want.index_add_(0, tok, gate[tok, j, None]
                            * (he @ pm["wo"][e].float()))
            n_kept += int(tok.numel())
    got = y.reshape(-1, cfg.d_model).float()
    moe_err = float((got - want).abs().max())
    scale = float(want.abs().max())
    check(n_kept == int(rs.keep.sum()) and n_kept > 0
          and moe_err <= 2e-2 * scale,
          f"[lm/moe] kimi-k2 moe_layer differs from the loop over its kept "
          f"choices: max |err| {moe_err} against max |y| {scale}")
    print(f"[lm/moe] kimi-k2-1t-a32b at full width, {KIMI_LAYERS} of 61 "
          f"layers ({model.n_params():,} params, {model.n_active_params():,}"
          f" active; bfloat16), init {init_ms / 1e3:.2f} s; prefill 1 x "
          f"{LM_SEQ} tokens {prefill_ms:.1f} ms, decode {decode_ms:.2f} ms "
          f"per token (cache {LM_SEQ + 1}, "
          f"mean of {LM_DECODES}); layer 0 drops {kimi_drop:.4f} of its "
          f"choices at 1 x {LM_SEQ} (capacity {r.cap} per expert and group "
          f"of {r.topi.shape[2]}; {why}); moe_layer on {MOE_CHECK_TOKENS} "
          f"tokens "
          f"(bfloat16) against the float32 loop over its {n_kept} kept "
          f"choices of {rs.keep.numel()} ({1 - n_kept / rs.keep.numel():.4f}"
          f" dropped, capacity {rs.cap}): max |err| {moe_err:.4g}, max |y| "
          f"{scale:.4g} (held to 2e-2 of it); phase 32 "
          f"{time.perf_counter() - t_phase:.1f} s; {card}")
    del params, model, h, hs, y, want, xs, pm, r, rs
    free()

    # ---- 33. [lm/ssm] falcon-mamba-7b serving and training ----
    t_phase = time.perf_counter()
    cfg = full_width("falcon-mamba-7b", MAMBA_SERVE_LAYERS, d_model=4096,
                     d_inner=8192, ssm_state=16, ssm_conv=4, ssm_chunk=32,
                     mamba_version=1, vocab_padded=65024)
    model = build_model(cfg)
    init_ms, params = once_ms(torch, lambda: model.init(threefry.PRNGKey(0),
                                                       dev))
    prefill_ms, decode_ms = serve(model, params, LM_BATCH,
                                  LM_SEQ, "lm/ssm")
    cut = dict(params, layers=tree_map(lambda v: v[:MAMBA_TRAIN_LAYERS],
                                       params["layers"]))
    err = decode_vs_prefill(cfg.replace(n_layers=MAMBA_TRAIN_LAYERS,
                                        compute_dtype="float32"), cut,
                            LM_BATCH, LM_CHECK_SEQ)
    print(f"[lm/ssm] falcon-mamba-7b at full width, "
          f"{MAMBA_SERVE_LAYERS} of 64 layers ({model.n_params():,} params, "
          f"bfloat16), init {init_ms / 1e3:.2f} s; prefill {LM_BATCH} x "
          f"{LM_SEQ} tokens {prefill_ms:.1f} ms, decode {decode_ms:.2f} ms "
          f"per token (mean of {LM_DECODES}); at {MAMBA_TRAIN_LAYERS} layers,"
          f" float32 compute, decode against a {LM_CHECK_SEQ}-token prefill "
          f"max |err| {err:.4g} (held to 1e-3); {card}")
    del params, cut, model
    free()
    train(build_model(cfg.replace(n_layers=MAMBA_TRAIN_LAYERS)), "lm/ssm")
    print(f"[lm/ssm] phase 33 {time.perf_counter() - t_phase:.1f} s; {card}")
    free()

    # ---- 34. [lm/hybrid] zamba2-7b at its own ssm_chunk of 128 ----
    t_phase = time.perf_counter()
    cfg = full_width("zamba2-7b", ZAMBA_LAYERS, d_model=3584, d_inner=7168,
                     ssm_heads=112, ssm_state=64, ssm_chunk=128,
                     attn_every=6, n_heads=32, n_kv=32, head_dim=112,
                     d_ff=14336, vocab_padded=32000)
    model = build_model(cfg)
    train(model, "lm/hybrid")
    free()
    init_ms, params = once_ms(torch, lambda: model.init(threefry.PRNGKey(0),
                                                       dev))
    prefill_ms, decode_ms = serve(model, params, LM_BATCH,
                                  LM_SEQ, "lm/hybrid")
    err = decode_vs_prefill(cfg.replace(compute_dtype="float32"), params,
                            LM_BATCH, LM_CHECK_SEQ)
    print(f"[lm/hybrid] zamba2-7b at full width, {ZAMBA_LAYERS} of 81 "
          f"layers, {ZAMBA_LAYERS // cfg.attn_every} shared-attention "
          f"applications ({model.n_params():,} params, bfloat16), init "
          f"{init_ms / 1e3:.2f} s; prefill {LM_BATCH} x {LM_SEQ} tokens "
          f"{prefill_ms:.1f} ms, decode "
          f"{decode_ms:.2f} ms per token (mean of {LM_DECODES}); float32 "
          f"compute: decode against a {LM_CHECK_SEQ}-token prefill max "
          f"|err| {err:.4g} (held to 1e-3); phase 34 "
          f"{time.perf_counter() - t_phase:.1f} s; {card}")
    del params, model
    free()

    # ---- 35. [lm/encdec] whisper-small whole ----
    t_phase = time.perf_counter()
    cfg = full_width("whisper-small", 12, d_model=768, n_heads=12, n_kv=12,
                     head_dim=64, d_ff=3072, enc_layers=12, enc_len=1500,
                     vocab_padded=51968)
    model = build_model(cfg)
    train(model, "lm/encdec")
    free()
    init_ms, params = once_ms(torch, lambda: model.init(threefry.PRNGKey(0),
                                                       dev))
    prefill_ms, decode_ms = serve(model, params, LM_BATCH,
                                  LM_SEQ, "lm/encdec")
    err = decode_vs_prefill(cfg.replace(compute_dtype="float32"), params,
                            LM_BATCH, LM_CHECK_SEQ)
    print(f"[lm/encdec] whisper-small whole (12 + 12 layers, "
          f"{cfg.enc_len} frames; {model.n_params():,} params, bfloat16), "
          f"init {init_ms / 1e3:.2f} s; prefill {LM_BATCH} x {LM_SEQ} "
          f"decoder tokens {prefill_ms:.1f} ms, decode {decode_ms:.2f} ms "
          f"per token (mean of {LM_DECODES});"
          f" float32 compute: decode against a {LM_CHECK_SEQ}-token prefill "
          f"max |err| {err:.4g} (held to 1e-3); phase 35 "
          f"{time.perf_counter() - t_phase:.1f} s; {card}")
    del params, model
    free()


def leaf_sums(torch, tree):
    """Per leaf of a tree of (DTensor or plain) tensors on the card, in
    ``tree_leaves`` order: (path, the sum of its raw words as int64, the
    sum of its squares in float64). Equal sums of the raw words and the
    squares stand for equal bits."""
    from torch.distributed.tensor import DTensor
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    out = []

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{path}/{k}" if path else k)
            return
        if isinstance(t, DTensor):
            t = t.to_local()
        w = t.detach().view(ints[t.element_size()])
        out.append((path, int(torch.sum(w, dtype=torch.int64)),
                    float(torch.sum(t.detach().double().square()))))
    walk(tree, "")
    return out


def whole_value(t):
    """A DTensor's global value as a plain tensor; a tensor as it is."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def lm_mesh_phases(torch, np, dev, card, kept):
    """The LM appendix's multi-device layer on the one card (phases
    36-37): ``[lm/mesh]`` phase 29's six AdamW steps on a (1, 1) ``data x
    model`` mesh of ``cuda:0`` in a world of one under NCCL, the state
    placed by the rules and ``activation_sharding`` on, held to what
    phase 29 kept, and the dry-run of the same cell beside it;
    ``[lm/pipeline]`` ``pipeline_apply`` of granite-3-8b's decoder layers
    at full width (float32), 2 per stage, over 4 stages on four
    ``cuda:0`` entries, held to the sequential composition."""
    import torch.distributed as dist

    from repro_torch.configs import ARCHS as LM_ARCHS
    from repro_torch.configs import ShapeConfig
    from repro_torch.core import threefry
    from repro_torch.data import batch_for_model
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model, spec, transformer
    from repro_torch.models.spec import tree_map
    from repro_torch.optim import cosine_schedule
    from repro_torch.parallel.ctx import activation_sharding
    from repro_torch.parallel.pipeline import pipeline_apply, split_stages
    from repro_torch.parallel.sharding import distribute_batch, make_rules
    from repro_torch.runtime import train_lib

    # ---- 36. [lm/mesh] phase 29's steps on a (1, 1) mesh ----
    t_phase = time.perf_counter()
    note = "NCCL_SOCKET_IFNAME as the machine sets it"
    if "NCCL_SOCKET_IFNAME" not in os.environ:
        # a world of one talks to no other host: the loopback suffices on
        # a machine without a network
        os.environ["NCCL_SOCKET_IFNAME"] = "lo"
        note = "NCCL_SOCKET_IFNAME=lo set by this phase"
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    cfg = LM_ARCHS[LM_ARCH].replace(n_layers=LM_LAYERS)
    model = build_model(cfg)
    shape = ShapeConfig("train_4k", LM_SEQ, LM_BATCH, "train")
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        rules = make_rules(mesh, dict(cfg.rule_overrides), "train",
                           LM_BATCH)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = train_lib.place_state(
            model, train_lib.init_state(model, threefry.PRNGKey(0),
                                        device=dev), mesh, rules)
        step_fn = train_lib.make_train_step(model,
                                            schedule=cosine_schedule())
        losses, norms, walls, hosts = [], [], [], []
        for s in range(LM_STEPS):
            batch = distribute_batch(
                batch_for_model(model, shape, s, 0, device=dev), mesh, rules)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with activation_sharding(mesh, rules):
                state, met = step_fn(state, batch)
            hosts.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            losses.append(float(whole_value(met["loss"])))
            norms.append(float(whole_value(met["grad_norm"])))
        peak = torch.cuda.max_memory_allocated()
        sums = leaf_sums(torch, state["params"])

        def step_once():
            with activation_sharding(mesh, rules):
                step_fn(state, batch)
        _, _, _, launches = lm_step_profile(torch, step_once)
        del state, met, batch
    finally:
        dist.destroy_process_group()
    steady = sum(walls[1:]) / (LM_STEPS - 1)
    host_share = sum(hosts[1:]) / sum(walls[1:])
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
          f"[lm/mesh] losses {losses}, grad norms {norms}")
    bits = (losses == kept["losses"] and norms == kept["norms"]
            and sums == kept["sums"])
    first = next(((a[0], a[1:], b[1:]) for a, b in zip(sums, kept["sums"])
                  if a != b), None)
    check(bits, f"[lm/mesh] not bit for bit to phase 29: losses {losses} "
                f"against {kept['losses']}, grad norms {norms} against "
                f"{kept['norms']}; first param leaf that differs (path, "
                f"(word sum, square sum) here, in phase 29) {first}")
    same = ("equal bit for bit to phase 29 (losses, grad norms, every "
            f"param leaf's checksum of {len(sums)})")
    print(f"[lm/mesh] {LM_ARCH} {LM_LAYERS} layers on a (1, 1) data x "
          f"model mesh of cuda:0 (NCCL, a world of one; {note}), state "
          f"placed by the rules, activation_sharding on, phase 29's "
          f"{LM_STEPS} AdamW steps of {LM_BATCH} x {LM_SEQ}: {same}; "
          f"{steady * 1e3:.1f} ms per step after the first (first "
          f"{walls[0] * 1e3:.1f}; phase 29 {kept['step_ms']:.1f}), host "
          f"share {host_share:.3f} (the call's return over the card's "
          f"finish), {launches} device launches per step (phase 29 "
          f"{kept['launches']}), max_memory_allocated "
          f"{peak / 2 ** 30:.2f} GiB (phase 29 {kept['peak'] / 2 ** 30:.2f}); "
          f"{card}")

    # the dry-run of the same cell on a (1, 1) mesh of a fake world of one
    dryrun.init_fake_world(1)
    try:
        rec = dryrun.lower_lm_cell(
            LM_ARCH, shape, False, cfg_overrides={"n_layers": LM_LAYERS},
            mesh=make_mesh((1, 1), ("data", "model"), device_type="cpu"))
    finally:
        dist.destroy_process_group()
    rl = rec["roofline"]
    print(f"[lm/mesh] the dry-run of the same cell on (1, 1): "
          f"{rl['flops_per_chip']:.4g} FLOPs, {rl['bytes_per_chip']:.4g} "
          f"bytes (unfused), compute {rl['compute_s'] * 1e3:.1f} ms, memory "
          f"{rl['memory_s'] * 1e3:.1f} ms, collective "
          f"{rl['collective_s'] * 1e3:.1f} ms: bound {rl['bound_s'] * 1e3:.1f}"
          f" ms ({rl['dominant']}) against the measured "
          f"{steady * 1e3:.1f} ms ({rl['bound_s'] / steady:.3f} of it); "
          f"peak live {rec['memory']['peak_live_bytes'] / 2 ** 30:.2f} GiB "
          f"(arguments {rec['memory']['argument_size_in_bytes'] / 2 ** 30:.2f}"
          f") against max_memory_allocated {peak / 2 ** 30:.2f}; useful-FLOPs "
          f"ratio {rl['useful_flops_ratio']:.3f}; traced in "
          f"{rec['trace_s']} s; phase 36 {time.perf_counter() - t_phase:.1f} "
          f"s; {card}")
    del model
    torch.cuda.empty_cache()

    # ---- 37. [lm/pipeline] GPipe over four stages of cuda:0 ----
    t_phase = time.perf_counter()
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    layers = spec.initialize(build_model(cfg32).param_specs["layers"],
                             threefry.PRNGKey(0), dev)
    stages = split_stages(layers, PIPE_STAGES)
    x = threefry.normal(threefry.PRNGKey(3), (PIPE_BATCH, LM_SEQ,
                                              cfg.d_model), device=dev)
    positions = torch.arange(LM_SEQ, device=dev)

    def block(p, h):
        for lp in transformer._unstack(p):
            h, _, _ = transformer._mixer_block(cfg32, lp, h, positions,
                                               None, "train")
        return h

    def stage(i):
        return tree_map(lambda a: a[i], stages)

    def sequential(xs):
        for i in range(PIPE_STAGES):
            xs = block(stage(i), xs)
        return xs

    devices = [dev] * PIPE_STAGES
    with torch.no_grad():
        seq_ms, whole = once_ms(torch, lambda: sequential(x))
        lines = []
        for n_micro in (4, 1):
            pipe_ms, got = once_ms(torch, lambda: pipeline_apply(
                block, stages, x, n_micro, devices))
            per_micro = torch.cat([sequential(xm) for xm in
                                   x.reshape(n_micro, -1, *x.shape[1:])])
            err = float((got - whole).abs().max())
            check(torch.equal(got, per_micro),
                  f"[lm/pipeline] n_micro {n_micro}: the pipeline differs "
                  f"from the sequential composition per micro-batch")
            check(bool(((got - whole).abs()
                        <= 1e-5 + 1e-5 * whole.abs()).all()),
                  f"[lm/pipeline] n_micro {n_micro}: beyond 1e-5 of the "
                  f"whole batch: max |err| {err}")
            lines.append(f"n_micro {n_micro}: {pipe_ms:.1f} ms, equal bit "
                         f"for bit to the sequential composition per "
                         f"micro-batch, max |err| {err:.3g} against the "
                         f"whole batch")
    print(f"[lm/pipeline] {LM_ARCH}'s decoder layers at full width "
          f"(float32), {LM_LAYERS // PIPE_STAGES} per stage over "
          f"{PIPE_STAGES} stages on cuda:0, batch {PIPE_BATCH} x {LM_SEQ}: "
          f"{'; '.join(lines)}; the sequential loop over the whole batch "
          f"{seq_ms:.1f} ms; phase 37 {time.perf_counter() - t_phase:.1f} "
          f"s; {card}")
    del layers, stages, x, whole, got, per_micro
    torch.cuda.empty_cache()


def lm_step_profile(torch, fn):
    """(device busy ms, the products' share of it, the six largest kernels
    with their device ms, the device launches: kernels, copies and fills)
    of one call of ``fn`` under ``torch.profiler`` (device activity only),
    read from its exported trace: a step of ~200,000 launches takes
    minutes through ``key_averages``; "not measured" where the trace holds
    no device time."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    dev_us, launches = {}, 0
    for evt in events:
        if evt.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            dev_us[evt["name"]] = (dev_us.get(evt["name"], 0.0)
                                   + float(evt.get("dur", 0.0)))
            launches += 1
    total = sum(dev_us.values())
    if total <= 0:
        return "not measured", "not measured", [], "not measured"
    gemm = sum(v for k, v in dev_us.items()
               if re.search(r"gemm|nvjet|sm90_|cutlass|xmma", k, re.I))
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:6]
    return (f"{total / 1e3:.1f} ms", f"{gemm / total:.3f}",
            [(k[:70], round(v / 1e3, 1)) for k, v in top], launches)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card; the port's smoke test needs one",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    import numpy as np
    from repro_torch.core import batched, dominance, engines, lattice, rng
    from repro_torch.core import sharded, threefry, trials
    from repro_torch.core import observables as obs
    from repro_torch.core.scenarios import (EngineConfig, RunConfig,
                                            compose, make_scenario)
    from repro_torch.core.simulation import simulate
    from repro_torch.kernels import build, density, escg_update, ops, philox
    from repro_torch.kernels import reference_scan
    from repro_torch.kernels import escg_update_fused as fused
    from repro_torch.parallel import sharding

    check(not any(m == "jax" or m.startswith("jax.") for m in sys.modules),
          "the port imported jax")
    dev = torch.device("cuda")
    card = smi("name,power.limit")
    print(card, flush=True)

    # ---- 2. build ----
    t0 = time.perf_counter()
    build.build()
    print(f"[build] nvcc {time.perf_counter() - t0:.2f}s, libraries "
          f"{build.LIBRARIES}")
    for lib in build.LIBRARIES:
        for line in build.build_log(lib).splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {lib}:", line.strip())

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

    dom_park3 = park3.dominance()

    def fused_trials_vs_simulate(k_mcs):
        """``build_trial_chunk`` of TR_FUSED_N park3 trials at SIDE on
        ``pallas_fused`` (two chunks of TR_CHUNK), each trial's final
        lattice, counts and kept count held to ``simulate`` from its
        lattice and run key; returns the initial lattices and keys, the
        final counts, and ms/MCS of the batch and of one simulate."""
        p_tr = compose(park3, EngineConfig(engine="pallas_fused", tile=TILE,
                                           k_mcs=k_mcs),
                       RunConfig(length=SIDE, height=SIDE, mcs=TR_MCS,
                                 chunk_mcs=TR_CHUNK, observables=()))
        built = engines.build(p_tr, dom_park3, dev)
        grids0, keys0 = trials.trial_grids_and_keys(
            p_tr, threefry.PRNGKey(p_tr.seed), TR_FUSED_N, dev)
        chunk = trials.build_trial_chunk(p_tr, built)
        g, kk, kept_sum = grids0, keys0, 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TR_MCS // TR_CHUNK):
            g, kk, cnt, _, kept, _ = chunk(g, kk, TR_CHUNK)
            kept_sum = kept_sum + kept
        cnt_h = cnt.cpu().numpy()
        batch_ms = (time.perf_counter() - t0) / TR_MCS * 1e3
        stamps = []
        for t in range(TR_FUSED_N):
            s1 = simulate(p_tr, dom_park3, grid0=grids0[t], key=keys0[t],
                          stop_on_stasis=False, device=dev,
                          hooks=[lambda m, g_, c: stamps.append(
                              time.perf_counter())] if t == 0 else ())
            check(np.array_equal(s1.grid, g[t].cpu().numpy())
                  and np.array_equal(s1.densities[-1],
                                     cnt_h[t] / p_tr.n_cells)
                  and s1.kept_fraction == 1.0
                  and int(kept_sum[t]) == TR_MCS * built.attempts_per_mcs,
                  f"trial {t} at k_mcs={k_mcs} differs from simulate")
        single_ms = (stamps[1] - stamps[0]) / TR_CHUNK * 1e3
        return grids0, keys0, cnt_h, batch_ms, single_ms

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
    for shift in ((1, 1), (SIDE - 1, SIDE - 1)):
        a = fused.escg_tile_round_fused(g_main, (3, 4), 0, dom, dirs, TILE,
                                        k, te, tem, 4, shift=shift)
        b = fused.escg_tile_round_fused_plain(
            torch.roll(g_main, (-shift[0], -shift[1]), (0, 1)), (3, 4), 0,
            dom, TILE, k, te, tem, 4)
        torch.cuda.synchronize()
        err = max_err(torch, a, b)
        k1_err = max(k1_err, err)
        print(f"[K1] {SIDE}x{SIDE} int32 shift {shift} against torch.roll "
              f"and the plain K1: max_abs_err {err}")
    edges = edge_cases(torch)
    edge_err = 0.0
    for dtype, nbhd, tile, k_edge, offset, gtw, _, e_shifts in edges:
        g = grid_on_card(EDGE_SIDE, 5, dtype, 2)
        a = fused.escg_tile_round_fused(g, (2 ** 32 - 1, 9), 1, dom5, dirs,
                                        tile, k_edge, 0.25, 0.6, nbhd,
                                        offset, gtw, e_shifts[0])
        b = fused.escg_tile_round_fused_plain(
            torch.roll(g, (-e_shifts[0][0], -e_shifts[0][1]), (0, 1)),
            (2 ** 32 - 1, 9), 1, dom5, tile, k_edge, 0.25, 0.6, nbhd, offset,
            gtw)
        torch.cuda.synchronize()
        edge_err = max(edge_err, max_err(torch, a, b))
    k1_err = max(k1_err, edge_err)
    print(f"[K1] {len(edges)} edge cases at {EDGE_SIDE}x{EDGE_SIDE} (int8, "
          f"int16, int32; nbhd 4, 8; tiles {EDGE_TILES}; K = th*tw and "
          f"th*tw - 7; tile_offset (3, 7) with grid_tiles_w 111; shifts "
          f"with 0, 1, H-1, W-1; partial blocks of tiles): max_abs_err "
          f"{edge_err}")
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
          f"{fused.cooperative_blocks(g_main, 3, TILE)}, counts[-1] "
          f"{ca[-1].tolist()}")
    edge_err = 0.0
    for dtype, nbhd, tile, k_edge, offset, gtw, steps, e_shifts in edges:
        g = grid_on_card(EDGE_SIDE, 5, dtype, 3)
        seeds_e = torch.tensor([[(0, 2 ** 32 - 1), (2 ** 32 - 1, 5),
                                 (11, 12)][t % 3] for t in range(steps)],
                               dtype=torch.int64, device=dev)
        shifts_e = torch.tensor(e_shifts, dtype=torch.int64, device=dev)
        ga, ca = fused.escg_tile_rounds_fused(
            g, seeds_e, shifts_e, dom5, dirs, tile, k_edge, 0.25, 0.6, 5,
            nbhd, offset, gtw)
        gb, cb = fused.escg_tile_rounds_fused_plain(
            g, seeds_e, shifts_e, dom5, tile, k_edge, 0.25, 0.6, 5, nbhd,
            offset, gtw)
        torch.cuda.synchronize()
        edge_err = max(edge_err, max_err(torch, ga, gb),
                       max_err(torch, ca, cb))
    k2_err = max(k2_err, edge_err)
    print(f"[K2] the {len(edges)} edge cases as K1's, with K = 1, 3 and 10 "
          f"steps: max_abs_err {edge_err} (grid and counts)")
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
    results, launches, rolls = {}, {}, {}
    for k_mcs in (1, K_MCS):
        stamps = []
        ops.reset_launches()
        t0 = time.perf_counter()
        with counted_rolls(torch, rolls, k_mcs):
            r = simulate(park3,
                         engine=EngineConfig(engine="pallas_fused",
                                             tile=TILE, k_mcs=k_mcs),
                         run=run,
                         hooks=[lambda m, g, c: stamps.append(
                             time.perf_counter())])
        wall = time.perf_counter() - t0
        launches[k_mcs] = ops.launches()
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
              f"{per_mcs:.4f} ms/MCS; launches {launches[k_mcs]}; "
              f"torch.roll calls {rolls[k_mcs]}; final densities "
              f"{dens[-1].tolist()}")
    check(rolls[1] == 0, f"k_mcs=1 rolled the lattice outside K1 "
          f"({rolls[1]} torch.roll calls)")
    check(launches[1]["escg_tile_round_fused"] == MCS
          and launches[1]["escg_tile_rounds_fused"] == 0
          and launches[1]["density_counts"] == MCS + 1,
          f"k_mcs=1 did not run through K1 and K4: {launches[1]}")
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
            ("K2", k2_ms, k2_plain, k2_bound, k2_by)):
        print(f"[time] {name}{' (K=10)' if name == 'K2' else ''}: "
              f"{ms:.4f} ms per launch (after its redesign "
              f"{REDESIGNED_MS[name]} ms; before it {PREVIOUS_MS[name]} ms, "
              f"{PREVIOUS_MS[name] / ms:.2f}x), plain {plain:.2f} ms, bound "
              f"{bnd * 1e3:.1f} us by {by}, {bnd / ms:.3f} of the bound's "
              f"time (instruction rate {instr_per_s / 1e12:.2f} T/s at "
              f"{clock_hz / 1e9:.2f} GHz); library call: none computes a "
              f"sequential tile sweep; {card}")

    # ---- 8. [threefry] the stream-fed engines' draws, card against host --
    interior = (th - 2) * (tw - 2)
    tile_ids = torch.arange(n_tiles, device=dev)
    kp = threefry.split(threefry.PRNGKey(5))[0]
    on_card = rng.tile_stream_batch(kp.to(dev), tile_ids, k, interior, 4)
    on_host = rng.tile_stream_batch(kp, tile_ids.cpu(), k, interior, 4)
    for name, a, b in zip(on_card._fields, on_card, on_host):
        check(a.is_cuda and torch.equal(a.cpu(), b),
              f"tile_stream_batch field {name} differs card/host")
    stream_ms = event_ms(torch, lambda: rng.tile_stream_batch(
        kp.to(dev), tile_ids, k, interior, 4), 5)
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    rng.tile_stream_batch(kp.to(dev), tile_ids, k, interior, 4)
    peak_gb = (torch.cuda.max_memory_allocated() - base_mem) / 1e9
    print(f"[threefry] tile_stream_batch {n_tiles} tiles x {k}: card equals "
          f"host in all 4 fields of all tiles; {stream_ms:.3f} ms per MCS "
          f"on the card, peak {peak_gb:.2f} GB above the resident tensors")

    # ---- 9. [K3] the stream-fed round against its plain version ----
    def rolled(grid, shift):
        return torch.roll(grid, (-shift[0], -shift[1]), (0, 1))

    k3_err = 0.0
    for seed in (1, 2, 3):
        props = rng.tile_stream_batch(threefry.PRNGKey(seed).to(dev),
                                      tile_ids, k, interior, 4)
        for shift in ((0, 0), (1, 1), (th - 1, tw - 1)):
            a = escg_update.escg_tile_round(g_main, *props, dom, dirs, TILE,
                                            te, tem, shift)
            g_in = rolled(g_main, shift)
            b = escg_update.escg_tile_round_plain(g_in, *props, dom, TILE,
                                                  te, tem)
            torch.cuda.synchronize()
            err = max_err(torch, a, b)
            k3_err = max(k3_err, err)
            print(f"[K3] {SIDE}x{SIDE} int32 nbhd 4 stream key {seed} shift "
                  f"{shift} against torch.roll and the plain K3: "
                  f"max_abs_err {err}, cells changed "
                  f"{int((a != g_in).sum())}")
    n8 = (512 // th) * (512 // tw)
    props8 = rng.tile_stream_batch(threefry.PRNGKey(4).to(dev),
                                   torch.arange(n8, device=dev), k8,
                                   interior, 8)
    a = escg_update.escg_tile_round(g8, *props8, dom5, dirs, TILE, 0.25,
                                    0.6)
    b = escg_update.escg_tile_round_plain(g8, *props8, dom5, TILE, 0.25,
                                          0.6)
    torch.cuda.synchronize()
    err = max_err(torch, a, b)
    k3_err = max(k3_err, err)
    print(f"[K3] {g8.shape[0]}x{g8.shape[1]} int8 nbhd 8: max_abs_err "
          f"{err}")
    k3_edges = stream_edge_cases(torch, escg_update.CHUNK)
    edge_err = 0.0
    for i, (dtype, nbhd, tile, k_edge, shift) in enumerate(k3_edges):
        g = grid_on_card(EDGE_SIDE, 5, dtype, 4)
        n_edge = (EDGE_SIDE // tile[0]) * (EDGE_SIDE // tile[1])
        props = rng.tile_stream_batch(
            threefry.PRNGKey(10 + i).to(dev), torch.arange(n_edge, device=dev),
            k_edge, (tile[0] - 2) * (tile[1] - 2), nbhd)
        a = escg_update.escg_tile_round(g, *props, dom5, dirs, tile, 0.25,
                                        0.6, shift)
        b = escg_update.escg_tile_round_plain(rolled(g, shift), *props, dom5,
                                              tile, 0.25, 0.6)
        torch.cuda.synchronize()
        edge_err = max(edge_err, max_err(torch, a, b))
    k3_err = max(k3_err, edge_err)
    print(f"[K3] {len(k3_edges)} edge cases at {EDGE_SIDE}x{EDGE_SIDE} "
          f"(int8, int16, int32; nbhd 4, 8; tiles {EDGE_TILES}; K = th*tw, "
          f"th*tw - 7 and {escg_update.CHUNK - 3} < one chunk of "
          f"{escg_update.CHUNK}; shifts with 0, 1, H-1, W-1; partial blocks "
          f"of tiles) against torch.roll and the plain K3: max_abs_err "
          f"{edge_err}")
    check(k3_err == 0.0, f"K3 disagrees with its plain version ({k3_err})")

    # ---- 10. [pallas] the stream-fed engine, held to the plain sweep ----
    def park3_run(engine, mcs, chunk, observables=None, hooks=(), k_mcs=1):
        return simulate(park3,
                        engine=EngineConfig(engine=engine, tile=TILE,
                                            k_mcs=k_mcs),
                        run=RunConfig(length=SIDE, height=SIDE, mcs=mcs,
                                      chunk_mcs=chunk,
                                      observables=observables),
                        hooks=hooks)
    few = {e: park3_run(e, 5, 5) for e in ("pallas", "sublattice")}
    check(set(few["pallas"].observables) == {"densities",
                                             "interface_length"},
          f"park3 streamed {sorted(few['pallas'].observables)}")
    check(np.array_equal(few["pallas"].grid, few["sublattice"].grid),
          "pallas differs from sublattice in the final lattice")
    for name, stream in few["pallas"].observables.items():
        check(np.array_equal(stream, few["sublattice"].observables[name]),
              f"pallas differs from sublattice in {name}")
    print(f"[pallas] park3 {SIDE}x{SIDE} 5 MCS: pallas equals sublattice "
          "(the plain sweep on the card) in the final lattice and every "
          "densities and interface_length row")
    stamps = []
    ops.reset_launches()
    t0 = time.perf_counter()
    with counted_rolls(torch, rolls, "pallas"):
        r = park3_run("pallas", MCS, CHUNK,
                      hooks=[lambda m, g, c: stamps.append(
                          time.perf_counter())])
    wall = time.perf_counter() - t0
    launches["pallas"] = ops.launches()
    check(launches["pallas"]["escg_tile_round"] == MCS
          and launches["pallas"]["density_counts"] == MCS + 1,
          f"the pallas path did not run through K3 and K4: "
          f"{launches['pallas']}")
    check(rolls["pallas"] == 0, f"the pallas path rolled the lattice "
          f"outside K3 ({rolls['pallas']} torch.roll calls)")
    iface = r.observables["interface_length"]
    check(r.grid.shape == (SIDE, SIDE) and r.densities.shape == (MCS + 1, 4)
          and iface.shape == (MCS, 1) and np.isfinite(iface).all()
          and 0.0 < iface[-1, 0] < 1.0
          and np.abs(r.densities.sum(axis=1) - 1.0).max() < 1e-12,
          "the pallas path's streams are malformed")
    pallas_ms = (stamps[1] - stamps[0]) / CHUNK * 1e3
    print(f"[pallas] park3 {SIDE}x{SIDE} pallas {MCS} MCS with park3's "
          f"observables: {wall:.3f}s incl. set-up; second chunk "
          f"{pallas_ms:.4f} ms/MCS; launches {launches['pallas']}; "
          f"torch.roll calls {rolls['pallas']}; final "
          f"interface_length {float(iface[-1, 0])!r}; final densities "
          f"{r.densities[-1].tolist()}")

    # ---- 11. [obs] pallas_fused with every observable on ----
    obs_runs = {}
    for k_mcs in (1, K_MCS):
        res = park3_run("pallas_fused", MCS, CHUNK, ALL_OBS, k_mcs=k_mcs)
        obs_runs[k_mcs] = res
        check(np.array_equal(res.grid, results[k_mcs].grid)
              and np.array_equal(res.densities, results[k_mcs].densities),
              f"k_mcs={k_mcs}: observables on differ from off")
    one, ten = obs_runs[1], obs_runs[K_MCS]
    p_obs = compose(park3, EngineConfig(engine="pallas_fused", tile=TILE),
                    RunConfig(length=SIDE, height=SIDE,
                              observables=ALL_OBS))
    _, k0 = threefry.split(threefry.PRNGKey(0))    # seed 0's lattice
    g0 = lattice.init_grid(k0, SIDE, SIDE, 3, p.empty, device=dev)
    for spec in obs.observable_specs():
        name = spec.name
        if spec.from_counts:
            check(np.array_equal(ten.observables[name],
                                 one.observables[name]),
                  f"k_mcs={K_MCS} {name} differs from k_mcs=1")
            continue
        first = spec.post(spec.compute(g0, None, p_obs).double()
                          .cpu().numpy()[None], p_obs)[0]
        starts = [first] + [one.observables[name][K_MCS * g - 1]
                            for g in range(1, MCS // K_MCS)]
        held = np.stack([starts[t // K_MCS] for t in range(MCS)])
        check(np.array_equal(ten.observables[name], held),
              f"k_mcs={K_MCS} {name} is not lag-held")
    print(f"[obs] pallas_fused park3 {SIDE}x{SIDE} {MCS} MCS, observables "
          f"{ALL_OBS}: on equals off (lattice, densities) at k_mcs 1 and "
          f"{K_MCS}; at k_mcs={K_MCS} densities equal k_mcs=1 row for row "
          f"and the grid-derived streams are lag-held at group starts")

    # ---- 12. [K4] the species histogram ----
    def k4_against_plain(g, species):
        a = density.density_counts(g, species)
        b = density.density_counts_plain(g, species)
        valid = g[(g >= 0) & (g <= species)].long()
        lib = torch.bincount(valid, minlength=species + 1)
        torch.cuda.synchronize()
        return max(max_err(torch, a, b), max_err(torch, a, lib))

    k4_err = 0.0
    for label, grid in (("park3 lattice", g_main),
                        ("labels -2..S+3", None)):
        for dtype in (torch.int32, torch.int16, torch.int8):
            for species in K4_SPECIES:
                g = (grid if grid is not None else torch.randint(
                    -2, species + 4, (SIDE, SIDE), device=dev,
                    generator=torch.Generator(dev).manual_seed(species),
                    dtype=torch.int32)).to(dtype)
                err = max(k4_against_plain(g, species),
                          k4_against_plain(g.reshape(-1)[1:], species))
                k4_err = max(k4_err, err)
                print(f"[K4] {SIDE}x{SIDE} {label} {dtype} S={species} "
                      f"(whole, and the view from cell 1): max_abs_err "
                      f"{err} against plain and bincount")
    short_err = 0.0
    for dtype, species, n in itertools.product(
            (torch.int32, torch.int16, torch.int8), K4_SPECIES, K4_LENGTHS):
        x = torch.randint(-2, species + 4, (n + 1,), device=dev,
                          generator=torch.Generator(dev).manual_seed(n),
                          dtype=torch.int32).to(dtype)
        short_err = max(short_err, k4_against_plain(x[:n], species),
                        k4_against_plain(x[1:], species))
    k4_err = max(k4_err, short_err)
    print(f"[K4] lengths {K4_LENGTHS}, aligned and from cell 1, S in "
          f"{K4_SPECIES}, int32, int16, int8, labels -2..S+3: max_abs_err "
          f"{short_err} against plain and bincount")
    check(k4_err == 0.0, f"K4 disagrees ({k4_err})")

    # ---- 13. [K5] bulk Philox words and uniforms ----
    k5_err = 0.0
    for n in (K5_WORDS, 4 * 1024 * 37 + 3):
        a = philox.philox_bits(n, (0xDEADBEEF, 7), 3)
        b = philox.philox_bits_plain(n, (0xDEADBEEF, 7), 3, device=dev)
        ua = philox.philox_uniform(n, (0xDEADBEEF, 7), 3)
        ub = philox.philox_uniform_plain(n, (0xDEADBEEF, 7), 3, device=dev)
        torch.cuda.synchronize()
        check(a.dtype == torch.uint32 and a.shape == (n,) and
              ua.dtype == torch.float32 and ua.shape == (n,),
              "philox output has the wrong type or shape")
        err = max(max_err(torch, words(torch, a), words(torch, b)),
                  float((ua - ub).abs().max()))
        k5_err = max(k5_err, err)
        check(float(ua.min()) >= 0.0 and float(ua.max()) < 1.0,
              "philox_uniform left [0, 1)")
        print(f"[K5] n={n} stream 3: max_abs_err {err} (words and "
              f"uniforms); uniforms in [{float(ua.min())!r}, "
              f"{float(ua.max())!r}], mean {float(ua.double().mean())!r}")
    check(k5_err == 0.0, f"K5 disagrees with its plain version ({k5_err})")
    ops.reset_launches()
    u = ops.philox_uniform(K5_WORDS, (1, 2))
    bits = ops.philox_bits(K5_WORDS, (1, 2), stream=1)
    torch.cuda.synchronize()
    launches["philox"] = ops.launches()
    check(launches["philox"]["philox_bits"] == 2,
          f"the Philox path did not run through K5: {launches['philox']}")
    print(f"[K5] ops.philox_uniform + ops.philox_bits ({K5_WORDS} words "
          f"each): launches {launches['philox']}, uniform mean "
          f"{float(u.double().mean())!r}, word mean "
          f"{float(words(torch, bits).double().mean()) / 2 ** 32!r} of 2^32")

    # ---- 14. [time] K3, K4, K5 ----
    props = rng.tile_stream_batch(kp.to(dev), tile_ids, k, interior, 4)
    k3_ms = event_ms(torch, lambda: escg_update.escg_tile_round(
        g_main, *props, dom, dirs, TILE, te, tem), 50)
    k3_shift_ms = event_ms(torch, lambda: escg_update.escg_tile_round(
        g_main, *props, dom, dirs, TILE, te, tem, (th - 1, tw - 1)), 50)
    k3_plain = event_ms(torch, lambda: escg_update.escg_tile_round_plain(
        g_main, *props, dom, TILE, te, tem), 2)
    k3_bound, k3_by = bound(2 * cell_bytes + 4 * 4 * updates,
                            updates * OPS_PER_STREAM_UPDATE)
    k4_ms = event_ms(torch, lambda: density.density_counts(g_main, 3), 100)
    k4_device = profiled_ms(torch, lambda: density.density_counts(
        g_main, 3), 100, "density_kernel")
    k4_plain = event_ms(torch, lambda: density.density_counts_plain(
        g_main, 3), 10)
    k4_lib = event_ms(torch, lambda: torch.bincount(
        g_main.reshape(-1), minlength=4), 100)
    k4_bound, k4_by = bound(cell_bytes + 4 * 4,
                            SIDE * SIDE * OPS_PER_COUNTED_CELL)
    k5_ms = event_ms(torch, lambda: philox.philox_bits(K5_WORDS, (1, 2)),
                     50)
    k5_plain = event_ms(torch, lambda: philox.philox_bits_plain(
        K5_WORDS, (1, 2), device=dev), 3)
    k5_bound, k5_by = bound(4 * K5_WORDS,
                            K5_WORDS // 4 * OPS_PER_COUNTER)
    for name, ms, plain, bnd, by, lib_note in (
            ("K3", k3_ms, k3_plain, k3_bound, k3_by,
             f"none computes a sequential tile sweep; with the fused shift "
             f"{(th - 1, tw - 1)} {k3_shift_ms:.4f} ms"),
            ("K4", k4_ms, k4_plain, k4_bound, k4_by,
             f"torch.bincount {k4_lib:.4f} ms; device time by the profiler "
             f"{k4_device} per launch"),
            ("K5", k5_ms, k5_plain, k5_bound, k5_by,
             "none (torch's Philox has another counter layout)")):
        before = (f" (before the redesign {PREVIOUS_MS[name]} ms, "
                  f"{PREVIOUS_MS[name] / ms:.2f}x)"
                  if name in PREVIOUS_MS else "")
        print(f"[time] {name}: {ms:.4f} ms per launch{before}, plain "
              f"{plain:.2f} ms, bound {bnd * 1e3:.1f} us by {by}, "
              f"{bnd / ms:.3f} of the bound's time; library call: "
              f"{lib_note}; {card}")

    # ---- 15. [S1] the sequential scan against its plain version ----
    s1_err = 0.0
    for side, dtype, nbhd, flux, drop, n_props in itertools.product(
            S1_SIDES, (torch.int8, torch.int16, torch.int32), (4, 8),
            (True, False), (False, True), S1_PROPS):
        g = grid_on_card(side, 5, dtype, 5)
        props = rng.proposal_batch(threefry.PRNGKey(n_props + nbhd),
                                   n_props, side * side, nbhd, device=dev)
        ga, ka = reference_scan.reference_scan(g, *props, dom5, dirs, 0.25,
                                               0.6, flux, drop)
        gb, kb = reference_scan.reference_scan_plain(g, *props, dom5, 0.25,
                                                     0.6, flux, drop)
        torch.cuda.synchronize()
        check(ga.dtype == dtype and (int(ka) < n_props) == drop,
              f"S1 returned {ga.dtype}, kept {int(ka)} of {n_props}")
        s1_err = max(s1_err, max_err(torch, ga, gb),
                     abs(int(ka) - int(kb)))
    print(f"[S1] {S1_SIDES} sides, {S1_PROPS} proposals, int8, int16, "
          f"int32, nbhd 4, 8, flux True, False, drop_conflicts False, "
          f"True: max_abs_err {s1_err} (grid and kept) against the host "
          f"loop")
    n_window = p.n_cells // engines._pick_sub_batches(p.n_cells)
    window = rng.proposal_batch(threefry.PRNGKey(6), n_window, p.n_cells, 4,
                                device=dev)
    ga, ka = reference_scan.reference_scan(g_main, *window, dom, dirs, te,
                                           tem, True, True)
    gb, kb = batched.run_proposals(g_main, window, te, tem, dom, True)
    torch.cuda.synchronize()
    window_ms = event_ms(torch, lambda: reference_scan.reference_scan(
        g_main, *window, dom, dirs, te, tem, True, True), 5)
    err = max(max_err(torch, ga, gb), abs(int(ka) - int(kb)))
    s1_err = max(s1_err, err)
    print(f"[S1] {SIDE}x{SIDE} one batched window of {n_window} proposals: "
          f"S1 with drop_conflicts against batched.run_proposals on the "
          f"card: max_abs_err {err} (grid and kept), kept {int(ka)}; S1 "
          f"{window_ms:.3f} ms ({window_ms / n_window * 1e6:.2f} ns per "
          f"step; before the redesign {S1_PREVIOUS_NS['window']} ns)")
    s1_ms, s1_plain, ns_per_step = {}, {}, {}
    for side in S1_MCS_SIDES:
        g_ref = grid_on_card(side, 3, torch.int32, 0)
        n_ref = side * side
        ref_props = rng.proposal_batch(threefry.PRNGKey(8), n_ref, n_ref, 4,
                                       device=dev)
        ga, ka = reference_scan.reference_scan(g_ref, *ref_props, dom, dirs,
                                               te, tem, True)
        s1_ms[side] = event_ms(torch, lambda: reference_scan.reference_scan(
            g_ref, *ref_props, dom, dirs, te, tem, True), 5)
        t0 = time.perf_counter()
        gb, kb = reference_scan.reference_scan_plain(g_ref, *ref_props, dom,
                                                     te, tem, True)
        torch.cuda.synchronize()
        s1_plain[side] = (time.perf_counter() - t0) * 1e3
        err = max(max_err(torch, ga, gb), abs(int(ka) - int(kb)))
        s1_err = max(s1_err, err)
        ns_per_step[side] = s1_ms[side] / n_ref * 1e6
        print(f"[S1] {side}x{side} one MCS of {n_ref} proposals: max_abs_err "
              f"{err} (grid and kept) against the host loop; S1 "
              f"{s1_ms[side]:.3f} ms ({ns_per_step[side]:.2f} ns per step; "
              f"before the redesign {S1_PREVIOUS_NS[side]} ns, "
              f"{S1_PREVIOUS_NS[side] / ns_per_step[side]:.1f}x), host loop "
              f"{s1_plain[side]:.1f} ms; {card}")
    check(s1_err == 0.0, f"S1 disagrees ({s1_err})")
    n_l1 = 1 << 20
    for side in S1_SIDES:
        l1_props = rng.proposal_batch(threefry.PRNGKey(9), n_l1, side * side,
                                      4, device=dev)
        g_l1 = grid_on_card(side, 3, torch.int32, 9)
        ns_per_step[side] = event_ms(
            torch, lambda: reference_scan.reference_scan(
                g_l1, *l1_props, dom, dirs, te, tem, True), 3) / n_l1 * 1e6
        print(f"[S1] {side}x{side}, {n_l1} proposals (most steps share a "
              f"cell with an earlier one of their window): "
              f"{ns_per_step[side]:.2f} ns per step (before the redesign "
              f"{S1_PREVIOUS_NS[side]} ns); {card}")

    # ---- 16. [golden] the reference golden through simulate ----
    with open(REF_GOLDEN) as f:
        want = json.load(f)
    cfg = want["params"]
    hashes = []
    ops.reset_launches()
    res = simulate(make_scenario("nspecies3", mobility=cfg["mobility"],
                                 empty=cfg["empty"]), dominance.RPS(),
                   engine=EngineConfig(engine="reference"),
                   run=RunConfig(length=cfg["length"], height=cfg["height"],
                                 mcs=cfg["mcs"], chunk_mcs=cfg["chunk_mcs"],
                                 seed=cfg["seed"], observables=()),
                   stop_on_stasis=False,
                   hooks=[lambda m, g, c: hashes.append(grid_hash(g))])
    check(ops.launches()["reference_scan"] == cfg["mcs"],
          f"the reference golden did not run through S1: {ops.launches()}")
    check(hashes == want["grid_hashes"], "reference golden hashes differ")
    check(np.array_equal(res.densities, np.asarray(want["densities"])),
          "reference golden densities differ")
    check(hashlib.sha256(res.grid.astype("<i4").tobytes()).hexdigest()
          == want["final_hash"], "reference golden final hash differs")
    check(res.kept_fraction == want["kept_fraction"],
          f"reference golden kept_fraction {res.kept_fraction}")
    print("[golden] tests/golden/reference_trajectory.json reproduced on "
          "the card through S1: 5 grid hashes, densities, final hash, "
          f"kept_fraction {res.kept_fraction}")

    # ---- 17. [batched] park3 on the default engine ----
    batched_runs = {}
    for label, observables in (("off", ()), ("declared", None)):
        stamps = []
        ops.reset_launches()
        t0 = time.perf_counter()
        r = simulate(park3, engine=EngineConfig(engine="batched"),
                     run=RunConfig(length=SIDE, height=SIDE, mcs=MCS,
                                   chunk_mcs=CHUNK, observables=observables),
                     hooks=[lambda m, g, c: stamps.append(
                         time.perf_counter())])
        wall = time.perf_counter() - t0
        launches[f"batched_{label}"] = counted = ops.launches()
        batched_runs[label] = r
        check(counted["density_counts"] == MCS + 1
              and sum(counted.values()) == MCS + 1,
              f"the batched path ran other kernels than K4: {counted}")
        check(r.grid.shape == (SIDE, SIDE) and r.mcs_completed == MCS
              and r.densities.shape == (MCS + 1, 4)
              and np.abs(r.densities.sum(axis=1) - 1.0).max() < 1e-12
              and 0.0 < r.kept_fraction < 1.0,
              f"the batched path's result is malformed (kept_fraction "
              f"{r.kept_fraction})")
        batched_ms = (stamps[1] - stamps[0]) / CHUNK * 1e3
        print(f"[batched] park3 {SIDE}x{SIDE} {MCS} MCS, observables "
              f"{label}: {wall:.3f}s incl. set-up; second chunk "
              f"{batched_ms:.4f} ms/MCS; launches {counted}; kept_fraction "
              f"{r.kept_fraction!r}; streams {sorted(r.observables)}; final "
              f"densities {r.densities[-1].tolist()}")
    check(np.array_equal(batched_runs["off"].grid,
                         batched_runs["declared"].grid)
          and np.array_equal(batched_runs["off"].densities,
                             batched_runs["declared"].densities)
          and set(batched_runs["declared"].observables)
          == {"densities", "interface_length"},
          "batched: observables on differ from off")
    small = {where: simulate(
        park3, run=RunConfig(length=BATCHED_CPU_SIDE, height=BATCHED_CPU_SIDE,
                             mcs=BATCHED_CPU_MCS, observables=()),
        device=on) for where, on in (("card", dev), ("host", "cpu"))}
    n_small = BATCHED_CPU_MCS * BATCHED_CPU_SIDE ** 2
    kept = {w: round(r.kept_fraction * n_small) for w, r in small.items()}
    check(grid_hash(torch.from_numpy(small["card"].grid))
          == grid_hash(torch.from_numpy(small["host"].grid))
          and kept["card"] == kept["host"],
          f"batched on the card differs from the CPU (kept {kept})")
    print(f"[batched] park3 {BATCHED_CPU_SIDE}x{BATCHED_CPU_SIDE} "
          f"{BATCHED_CPU_MCS} MCS on the default engine: the card equals "
          f"the CPU (grid hash, kept {kept['card']} of {n_small})")

    # ---- 18. [reference] park3 on the sequential engine ----
    stamps = []
    ops.reset_launches()
    t0 = time.perf_counter()
    r = simulate(park3, engine=EngineConfig(engine="reference"),
                 run=RunConfig(length=REF_SIDE, height=REF_SIDE, mcs=REF_MCS,
                               chunk_mcs=1, observables=()),
                 hooks=[lambda m, g, c: stamps.append(time.perf_counter())])
    wall = time.perf_counter() - t0
    launches["reference"] = counted = ops.launches()
    check(counted["reference_scan"] == REF_MCS
          and counted["density_counts"] == REF_MCS + 1
          and sum(counted.values()) == 2 * REF_MCS + 1,
          f"the reference path did not run through S1 and K4: {counted}")
    check(r.grid.shape == (REF_SIDE, REF_SIDE) and r.kept_fraction == 1.0
          and r.mcs_completed == REF_MCS
          and r.densities.shape == (REF_MCS + 1, 4)
          and np.isfinite(r.densities).all()
          and np.abs(r.densities.sum(axis=1) - 1.0).max() < 1e-12,
          "the reference path's result is malformed")
    ref_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    print(f"[reference] park3 {REF_SIDE}x{REF_SIDE} {REF_MCS} MCS: "
          f"{wall:.3f}s incl. set-up; MCS after the first "
          f"{[round(x, 4) for x in ref_ms]} ms; launches {counted}; "
          f"kept_fraction {r.kept_fraction}; final densities "
          f"{r.densities[-1].tolist()}; {card}")

    # S1's bound at the reference path's shape: each proposal read once
    # (16 bytes), the lattice read once and written once
    n_ref = REF_SIDE * REF_SIDE
    s1_bound, s1_by = bound(16 * n_ref + 2 * 4 * n_ref,
                            n_ref * OPS_PER_SCAN_STEP)
    print(f"[time] S1: {s1_ms[REF_SIDE]:.3f} ms per launch ({n_ref} "
          f"proposals, {REF_SIDE}x{REF_SIDE}; before the redesign "
          f"{PREVIOUS_MS['S1']} ms, "
          f"{PREVIOUS_MS['S1'] / s1_ms[REF_SIDE]:.1f}x), plain (the host "
          f"loop) {s1_plain[REF_SIDE]:.1f} ms, bound {s1_bound * 1e3:.1f} us "
          f"by {s1_by}, {s1_bound / s1_ms[REF_SIDE]:.2e} of the bound's "
          f"time; ns per step by side "
          f"{ {k: round(v, 2) for k, v in sorted(ns_per_step.items())} } "
          f"(before {S1_PREVIOUS_NS}); library call: none computes a "
          f"sequential scan; {card}")

    # ---- 19. [K4s] the histogram of a lattice decomposed over a mesh ----
    mesh4 = ["cuda:0"] * (SH_GRID[0] * SH_GRID[1])
    lat_main = sharded.place(g_main, sharding.lattice_mesh(
        SH_GRID, SIDE, SIDE, th, tw, devices=mesh4))
    ops.reset_launches()
    k4s = density.density_counts_sharded(lat_main.flat, 3)
    k4s_launches = ops.launches()
    whole = density.density_counts(g_main, 3)
    torch.cuda.synchronize()
    k4s_err = max(max_err(torch, k4s,
                          density.density_counts_plain(g_main, 3)),
                  max_err(torch, k4s, whole))
    check(k4s_launches["density_counts_sharded"] == 1
          and k4s_launches["density_counts"] == 0,
          f"density_counts_sharded did not make one grouped launch: "
          f"{k4s_launches}")
    check(k4s_err == 0.0, f"K4s disagrees with the plain count of the "
          f"whole lattice ({k4s_err})")
    k4s_ms = event_ms(torch, lambda: density.density_counts_sharded(
        lat_main.flat, 3), 100)
    k4s_device = profiled_ms(
        torch, lambda: density.density_counts_sharded(lat_main.flat, 3), 100,
        "density_kernel")
    k4s_plain = event_ms(torch, lambda: density.density_counts_plain(
        lat_main.gather(), 3), 10)
    k4s_lib = event_ms(torch, lambda: torch.stack(
        [torch.bincount(b.reshape(-1), minlength=4)
         for b in lat_main.flat]).sum(dim=0), 100)
    # the previous design in this run: K4 per block, a stack and a sum
    k4s_before = event_ms(torch, lambda: torch.stack(
        [density.density_counts(b, 3) for b in lat_main.flat]).sum(
            dim=0, dtype=torch.int32), 100)
    print(f"[K4s] density_counts_sharded of park3's {SIDE}x{SIDE} lattice "
          f"on a {SH_GRID} mesh of cuda:0: launches {k4s_launches}, "
          f"max_abs_err {k4s_err} against the plain count and K4 of the "
          f"whole lattice; {k4s_ms:.4f} ms per launch, device time by the "
          f"profiler {k4s_device} (before the redesign {PREVIOUS_MS['K4s']} "
          f"ms, {PREVIOUS_MS['K4s'] / k4s_ms:.2f}x; in this run, K4 per "
          f"block plus the stack and sum {k4s_before:.4f} ms; K4 on the "
          f"whole lattice "
          f"{k4_ms:.4f} ms), plain of the gathered lattice {k4s_plain:.4f} "
          f"ms, bound {k4_bound * 1e3:.1f} us by {k4_by}, library call "
          f"(torch.bincount per block plus the sum) {k4s_lib:.4f} ms; "
          f"{card}")

    # ---- 20. [sharded] the domain-decomposed engine on one card ----
    def timed(engine, device=None, side=SIDE, mcs=SH_MCS, chunk=SH_CHUNK,
              observables=(), key=None, **kw):
        """One ``simulate`` of park3 with the launch and roll counts and
        ms/MCS over its second chunk."""
        stamps = []
        ops.reset_launches()
        with counted_rolls(torch, rolls, key or engine):
            r = simulate(park3,
                         engine=EngineConfig(engine=engine, tile=TILE, **kw),
                         run=RunConfig(length=side, height=side, mcs=mcs,
                                       chunk_mcs=chunk,
                                       observables=observables),
                         device=device,
                         hooks=[lambda m, g, c: stamps.append(
                             time.perf_counter())])
        launches[key or engine] = ops.launches()
        ms = ((stamps[1] - stamps[0]) / chunk * 1e3 if len(stamps) > 1
              else None)
        return r, ms

    def same(a, b, names=("densities",)):
        return (np.array_equal(a.grid, b.grid)
                and all(np.array_equal(a.observables[n], b.observables[n])
                        for n in names))

    n_blocks = len(mesh4)
    twin, twin_ms = timed("pallas_fused", key="twin_fused")
    sh_f, sh_f_ms = timed("sharded", mesh4, key="sharded_fused",
                          shard_grid=SH_GRID, local_kernel="fused")
    counted = launches["sharded_fused"]
    check(counted["escg_tile_round_fused_table"] == SH_MCS
          and counted["escg_tile_round_fused"] == 0
          and counted["density_counts_sharded"] == SH_MCS + 1
          and counted["density_counts"] == 0
          and counted["escg_tile_rounds_fused"] == 0,
          f"sharded/fused did not run one K1 table launch per MCS for the "
          f"{n_blocks} blocks and one K4s launch per count: {counted}")
    check(rolls["sharded_fused"] == 0, f"sharded/fused rolled the lattice "
          f"outside K1 ({rolls['sharded_fused']} torch.roll calls)")
    check(same(sh_f, twin) and sh_f.grid.shape == (SIDE, SIDE)
          and grid_hash(torch.from_numpy(sh_f.grid))
          == grid_hash(torch.from_numpy(twin.grid)),
          "sharded/fused differs from pallas_fused")
    print(f"[sharded] fused park3 {SIDE}x{SIDE} on a {SH_GRID} mesh of "
          f"cuda:0, {SH_MCS} MCS: equals pallas_fused (final grid hash, "
          f"all {SH_MCS + 1} count rows); launches {counted}; torch.roll "
          f"calls {rolls['sharded_fused']}; second chunk {sh_f_ms:.4f} "
          f"ms/MCS against pallas_fused's {twin_ms:.4f}; {card}")
    sh_k, sh_k_ms = timed("sharded", ["cuda:0"], key="sharded_fused_k10",
                          shard_grid=(1, 1), local_kernel="fused",
                          k_mcs=K_MCS)
    counted = launches["sharded_fused_k10"]
    # each chunk runs whole groups of K_MCS and one remainder launch
    k2_launches = SH_MCS // SH_CHUNK * -(-SH_CHUNK // K_MCS)
    check(counted["escg_tile_rounds_fused"] == k2_launches
          and counted["escg_tile_round_fused"] == 0
          and counted["density_counts_sharded"] == 1
          and counted["density_counts"] == 0,
          f"sharded/fused (1, 1) k_mcs={K_MCS} did not run K2: {counted}")
    check(same(sh_k, twin), f"sharded/fused (1, 1) k_mcs={K_MCS} differs "
          "from pallas_fused")
    print(f"[sharded] fused park3 {SIDE}x{SIDE} on a (1, 1) mesh, k_mcs="
          f"{K_MCS}: equals pallas_fused at k_mcs=1; launches {counted}; "
          f"second chunk {sh_k_ms:.4f} ms/MCS; {card}")
    # the parts of a (2, 2) fused MCS: K1 on one block, and the halo
    # copies of a whole round
    blk = lat_main.blocks[1][1]
    k1_block_ms = event_ms(torch, lambda: fused.escg_tile_round_fused(
        blk, (1, 2), 0, dom, dirs, TILE, k, te, tem, 4,
        (blk.shape[0] // th, blk.shape[1] // tw), SIDE // tw), 50)
    halo_ms = event_ms(torch, lambda: sharded.shard_shift2d(
        lat_main, (th - 1, tw - 1), TILE), 50)
    print(f"[sharded] K1 on one {blk.shape[0]}x{blk.shape[1]} block with "
          f"its tile_offset: {k1_block_ms:.4f} ms per launch (x{n_blocks} "
          f"= {n_blocks * k1_block_ms:.4f}; K1 on the whole lattice "
          f"{k1_ms:.4f}); the halo copies of a {(th - 1, tw - 1)} shift on "
          f"the {SH_GRID} mesh {halo_ms:.4f} ms; {card}")

    twin_p, twin_p_ms = timed("pallas", observables=None, key="twin_pallas")
    sh_p, sh_p_ms = timed("sharded", mesh4, observables=None,
                          key="sharded_pallas", shard_grid=SH_GRID,
                          local_kernel="pallas")
    counted = launches["sharded_pallas"]
    check(counted["escg_tile_round_table"] == SH_MCS
          and counted["escg_tile_round"] == 0
          and counted["density_counts_sharded"] == SH_MCS + 1
          and counted["density_counts"] == 0,
          f"sharded/pallas did not run one K3 table launch per MCS for the "
          f"{n_blocks} blocks and one K4s launch per count: {counted}")
    check(rolls["sharded_pallas"] == 0, f"sharded/pallas rolled the "
          f"lattice outside K3 ({rolls['sharded_pallas']} torch.roll calls)")
    check(set(sh_p.observables) == {"densities", "interface_length"}
          and same(sh_p, twin_p, ("densities", "interface_length")),
          "sharded/pallas differs from pallas")
    print(f"[sharded] pallas park3 {SIDE}x{SIDE} on a {SH_GRID} mesh of "
          f"cuda:0 with park3's observables, {SH_MCS} MCS: equals pallas "
          f"(final grid, densities and interface_length rows); launches "
          f"{counted}; torch.roll calls {rolls['sharded_pallas']}; second "
          f"chunk {sh_p_ms:.4f} ms/MCS against pallas's {twin_p_ms:.4f}; "
          f"{card}")

    small = {lk: timed("sharded", mesh4, side=JNP_SIDE, mcs=JNP_MCS,
                       chunk=JNP_MCS, observables=None,
                       key=f"sharded_{lk}_small", shard_grid=SH_GRID,
                       local_kernel=lk)[0] for lk in ("jnp", "pallas")}
    check(same(small["jnp"], small["pallas"],
               ("densities", "interface_length")),
          "sharded/jnp differs from sharded/pallas")
    print(f"[sharded] jnp park3 {JNP_SIDE}x{JNP_SIDE} on a {SH_GRID} mesh, "
          f"{JNP_MCS} MCS: equals sharded/pallas (final grid, densities "
          f"and interface_length rows); launches "
          f"{launches['sharded_jnp_small']}")

    # ---- 21. [trials/fused] IID trials on pallas_fused ----
    def trial_grids(n_tr, side, species, dtype, seed):
        return torch.stack([grid_on_card(side, species, dtype, seed + t)
                            for t in range(n_tr)])

    def trial_rows(rows, n_tr):
        """(n_tr, *rows.shape) int64: each trial's rows rotated by its
        index, so that no two trials share a schedule."""
        return torch.stack([rows.roll(t, 0) for t in range(n_tr)])

    tr_k1_err = tr_k2_err = 0.0
    for i, (dtype, nbhd, tile, k_edge, _, _, steps, e_shifts) in enumerate(
            edges):
        n_tr = TR_EDGE_NS[i % 3]
        g = trial_grids(n_tr, EDGE_SIDE, 5, dtype, 20)
        words_e = torch.tensor([[(0, 2 ** 32 - 1), (2 ** 32 - 1, 5),
                                 (11, 12)][t % 3] for t in range(steps)],
                               dtype=torch.int64, device=dev)
        shifts_e = torch.tensor(e_shifts, dtype=torch.int64, device=dev)
        seeds_t = trial_rows(words_e, n_tr)
        shifts_t = trial_rows(shifts_e, n_tr)
        a = fused.escg_tile_round_fused_trials(
            g, seeds_t[:, 0].contiguous(), shifts_t[:, 0].contiguous(), dom5,
            dirs, tile, k_edge, 0.25, 0.6, nbhd)
        b = fused.escg_tile_round_fused_trials_plain(
            g, seeds_t[:, 0], shifts_t[:, 0], dom5, tile, k_edge, 0.25, 0.6,
            nbhd)
        ga, ca = fused.escg_tile_rounds_fused_trials(
            g, seeds_t, shifts_t, dom5, dirs, tile, k_edge, 0.25, 0.6, 5,
            nbhd)
        gb, cb = fused.escg_tile_rounds_fused_trials_plain(
            g, seeds_t, shifts_t, dom5, tile, k_edge, 0.25, 0.6, 5, nbhd)
        torch.cuda.synchronize()
        tr_k1_err = max(tr_k1_err, max_err(torch, a, b))
        tr_k2_err = max(tr_k2_err, max_err(torch, ga, gb),
                        max_err(torch, ca, cb))
    print(f"[trials/fused] K1 and K2 over {TR_EDGE_NS} trials at the "
          f"{len(edges)} edge cases of K1 and K2 ({EDGE_SIDE}x{EDGE_SIDE}, "
          f"int8, int16, int32; nbhd 4, 8; tiles {EDGE_TILES}; K2 with 1, 3 "
          f"and 10 steps; each trial its own seeds and shifts, with 0, 1, "
          f"H-1, W-1; partial blocks of tiles): max_abs_err K1 {tr_k1_err}, "
          f"K2 {tr_k2_err} (grids and counts) against the plain versions")
    tr_k4_err = 0.0
    for dtype, species, n_tr, hw in itertools.product(
            (torch.int8, torch.int32), K4_SPECIES, TR_EDGE_NS,
            ((7, 9), (64, 64), (33, 31))):
        g = torch.randint(-2, species + 4, (n_tr,) + hw, device=dev,
                          generator=torch.Generator(dev).manual_seed(species),
                          dtype=torch.int32).to(dtype)
        a = density.density_counts_trials(g, species)
        b = density.density_counts_trials_plain(g, species)
        torch.cuda.synchronize()
        tr_k4_err = max(tr_k4_err, max_err(torch, a, b))
    print(f"[trials/fused] K4 per trial over {TR_EDGE_NS} trials of 7x9, "
          f"64x64 and 33x31 (slices that start anywhere), int8 and int32, S "
          f"in {K4_SPECIES}, labels -2..S+3: max_abs_err {tr_k4_err}")
    check(tr_k1_err == 0.0 and tr_k2_err == 0.0 and tr_k4_err == 0.0,
          f"the trial forms disagree with their plain versions: K1 "
          f"{tr_k1_err}, K2 {tr_k2_err}, K4 {tr_k4_err}")

    def fused_trials(n_tr, k_mcs, hooks=()):
        return trials.run_trials(
            park3, n_trials=n_tr,
            engine=EngineConfig(engine="pallas_fused", tile=TILE,
                                k_mcs=k_mcs),
            run=RunConfig(length=SIDE, height=SIDE, mcs=TR_MCS,
                          chunk_mcs=TR_CHUNK, observables=()),
            stop_on_stasis=False, hooks=hooks)

    tr_runs = {}
    for k_mcs in (1, K_MCS):
        for n_tr in (1, TR_FUSED_N):
            ops.reset_launches()
            t0 = time.perf_counter()
            r = fused_trials(n_tr, k_mcs)
            wall = time.perf_counter() - t0
            launches[f"trials_fused_{k_mcs}_{n_tr}"] = counted = \
                ops.launches()
            tr_runs[k_mcs, n_tr] = r
            check(r.densities.shape == (n_tr, 4) and r.mcs_completed == TR_MCS
                  and np.isfinite(r.densities).all()
                  and np.abs(r.densities.sum(axis=1) - 1.0).max() < 1e-12
                  and r.kept_fraction == 1.0 and r.n_devices == 1,
                  f"the fused trials' result is malformed ({n_tr} trials, "
                  f"k_mcs={k_mcs})")
            print(f"[trials/fused] park3 {SIDE}x{SIDE} {n_tr} trials "
                  f"k_mcs={k_mcs} {TR_MCS} MCS: {wall:.3f}s incl. set-up "
                  f"(the lattices' draws); launches {counted}; {card}")
        one, many = (launches[f"trials_fused_{k_mcs}_{n}"]
                     for n in (1, TR_FUSED_N))
        check(one == many, f"k_mcs={k_mcs}: launches grew with the trials: "
              f"{one} for 1, {many} for {TR_FUSED_N}")
        if k_mcs == 1:
            check(many["escg_tile_round_fused_trials"] == TR_MCS
                  and many["density_counts_trials"] == TR_MCS + 1
                  and many["escg_tile_round_fused"] == 0
                  and many["density_counts"] == 0,
                  f"the fused trials did not run one K1 and one K4 launch "
                  f"per MCS for all trials: {many}")
        else:
            check(many["escg_tile_rounds_fused_trials"] == TR_MCS // K_MCS
                  and many["density_counts_trials"] == 1
                  and many["escg_tile_round_fused_trials"] == 0,
                  f"the fused trials at k_mcs={K_MCS} did not run one K2 "
                  f"launch per {K_MCS} MCS: {many}")
        check(json.loads(tr_runs[k_mcs, 1].to_json())["densities"][0]
              == json.loads(tr_runs[k_mcs, TR_FUSED_N].to_json())
              ["densities"][0], "trial 0 depends on the trial count")
    check(tr_runs[1, TR_FUSED_N].to_json()
          == tr_runs[K_MCS, TR_FUSED_N].to_json(),
          f"the fused trials at k_mcs={K_MCS} differ from k_mcs=1")
    print(f"[trials/fused] launches per run equal for 1 and {TR_FUSED_N} "
          f"trials ({TR_MCS} K1 and {TR_MCS + 1} K4 launches, the count of "
          f"the initial lattices included; {TR_MCS // K_MCS} K2 at k_mcs="
          f"{K_MCS}); k_mcs={K_MCS} equals k_mcs=1 and trial 0 of "
          f"{TR_FUSED_N} equals the single trial")

    g16 = None
    for k_mcs in (1, K_MCS):
        grids0, keys0, cnt_h, batch_ms, single_ms = \
            fused_trials_vs_simulate(k_mcs)
        check(np.array_equal(cnt_h / p.n_cells,
                             tr_runs[k_mcs, TR_FUSED_N].densities),
              "build_trial_chunk differs from run_trials")
        print(f"[trials/fused] park3 {SIDE}x{SIDE} k_mcs={k_mcs}: "
              f"build_trial_chunk over {TR_FUSED_N} trials {batch_ms:.4f} "
              f"ms/MCS for the batch (two chunks of {TR_CHUNK}, the host key "
              f"chain included, no overlap), {batch_ms / TR_FUSED_N:.4f} per "
              f"trial; simulate of one trial {single_ms:.4f} ms/MCS (its "
              f"second chunk); {card}")
        if g16 is None:
            g16, keys16 = grids0, keys0
    print(f"[trials/fused] build_trial_chunk on the card: each of the "
          f"{TR_FUSED_N} trials' final lattice, counts and kept count equal "
          f"simulate from its lattice and run key, at k_mcs 1 and {K_MCS}")

    # the trial launches against n single launches, on the trials' lattices
    n16 = TR_FUSED_N
    seeds16 = keys16.to(dev)
    shifts16 = torch.tensor([[th - 1, tw - 1]] * n16, dtype=torch.int64,
                            device=dev)
    k1t_ms = event_ms(torch, lambda: fused.escg_tile_round_fused_trials(
        g16, seeds16, shifts16, dom, dirs, TILE, k, te, tem, 4), 10)
    k1n_ms = event_ms(torch, lambda: [fused.escg_tile_round_fused(
        g16[t], (1, 2), 0, dom, dirs, TILE, k, te, tem, 4, shift=(th - 1,
                                                                  tw - 1))
        for t in range(n16)], 5)
    k1t_plain, _ = once_ms(
        torch, lambda: fused.escg_tile_round_fused_trials_plain(
            g16, seeds16, shifts16, dom, TILE, k, te, tem, 4))
    seeds16k = trial_rows(seeds, n16)
    shifts16k = trial_rows(shifts, n16)
    k2t_ms = event_ms(torch, lambda: fused.escg_tile_rounds_fused_trials(
        g16, seeds16k, shifts16k, dom, dirs, TILE, k, te, tem, 3, 4), 3)
    k2n_ms = event_ms(torch, lambda: [fused.escg_tile_rounds_fused(
        g16[t], seeds, shifts, dom, dirs, TILE, k, te, tem, 3, 4)
        for t in range(n16)], 2)
    k2t_plain, _ = once_ms(
        torch, lambda: fused.escg_tile_rounds_fused_trials_plain(
            g16, seeds16k, shifts16k, dom, TILE, k, te, tem, 3, 4))
    k4t_ms = event_ms(torch, lambda: density.density_counts_trials(g16, 3),
                      50)
    k4t_device = profiled_ms(
        torch, lambda: density.density_counts_trials(g16, 3), 50,
        "density_kernel")
    k4n_ms = event_ms(torch, lambda: [density.density_counts(g16[t], 3)
                                      for t in range(n16)], 20)
    k4t_plain = event_ms(torch, lambda: density.density_counts_trials_plain(
        g16, 3), 5)
    # the library call: one bincount of every trial's labels offset by
    # t * (S + 1), which is K4 per trial on lattices of labels 0..S
    offsets = torch.arange(n16, device=dev)[:, None, None] * 4

    def k4t_library():
        return torch.bincount((g16.long() + offsets).reshape(-1),
                              minlength=n16 * 4).view(n16, 4)
    check(torch.equal(k4t_library().int(),
                      density.density_counts_trials(g16, 3)),
          "the offset bincount differs from K4 per trial")
    k4t_lib = event_ms(torch, k4t_library, 20)
    print(f"[time] K1 over {n16} trials at {SIDE}x{SIDE}: {k1t_ms:.4f} ms "
          f"per launch against {k1n_ms:.4f} for {n16} single launches (one "
          f"{k1_ms:.4f}); plain {k1t_plain:.1f} ms; bound {n16} x "
          f"{k1_bound * 1e3:.1f} us; cooperative blocks of K2 "
          f"{fused.cooperative_blocks(g16[0], 3, TILE)}; {card}")
    print(f"[time] K2 (K={K_MCS}) over {n16} trials: {k2t_ms:.4f} ms per "
          f"launch against {k2n_ms:.4f} for {n16} single launches (one "
          f"{k2_ms:.4f}); plain {k2t_plain:.1f} ms; bound {n16} x "
          f"{k2_bound * 1e3:.1f} us; {card}")
    print(f"[time] K4 per trial over {n16} trials: {k4t_ms:.4f} ms per "
          f"launch, device time by the profiler {k4t_device}, against "
          f"{k4n_ms:.4f} for {n16} single launches (one {k4_ms:.4f}); plain "
          f"{k4t_plain:.3f} ms; bound {n16} x {k4_bound * 1e3:.1f} us; "
          f"library call (one torch.bincount of the labels offset by t x "
          f"(S+1)) {k4t_lib:.4f} ms; {card}")

    # ---- 22. [trials/pallas] IID trials on the stream-fed engine ----
    tr_k3_err = 0.0
    k3_trial_edges = k3_edges[::4]
    for i, (dtype, nbhd, tile, k_edge, shift) in enumerate(k3_trial_edges):
        n_tr = TR_EDGE_NS[i % 3]
        g = trial_grids(n_tr, EDGE_SIDE, 5, dtype, 40)
        n_edge = (EDGE_SIDE // tile[0]) * (EDGE_SIDE // tile[1])
        props = rng.tile_stream_batch(
            threefry.split(threefry.PRNGKey(50 + i), n_tr).to(dev),
            torch.arange(n_edge, device=dev), k_edge,
            (tile[0] - 2) * (tile[1] - 2), nbhd)
        shifts_t = trial_rows(torch.tensor(
            [shift, (0, 0), (1, 1), (EDGE_SIDE - 1, EDGE_SIDE - 1)],
            dtype=torch.int64, device=dev), n_tr)[:, 0].contiguous()
        a = escg_update.escg_tile_round_trials(g, *props, dom5, dirs, tile,
                                               0.25, 0.6, shifts_t)
        b = escg_update.escg_tile_round_trials_plain(g, *props, dom5, tile,
                                                     0.25, 0.6, shifts_t)
        torch.cuda.synchronize()
        tr_k3_err = max(tr_k3_err, max_err(torch, a, b))
    print(f"[trials/pallas] K3 over {TR_EDGE_NS} trials at "
          f"{len(k3_trial_edges)} of K3's edge cases (every fourth: int8, "
          f"int16, int32; nbhd 4, 8; tiles {EDGE_TILES}; K = th*tw, th*tw - "
          f"7, less than a chunk; each trial its own streams and shift): "
          f"max_abs_err {tr_k3_err} against the plain version")
    check(tr_k3_err == 0.0, f"K3 over trials disagrees ({tr_k3_err})")

    p_pal = compose(park3, EngineConfig(engine="pallas", tile=TILE),
                    RunConfig(length=SIDE, height=SIDE, mcs=TR_PALLAS_MCS,
                              chunk_mcs=TR_PALLAS_MCS))
    p_pal = p_pal.replace(observables=("densities", "interface_length"))
    ops.reset_launches()
    t0 = time.perf_counter()
    with counted_rolls(torch, rolls, "trials_pallas"):
        rp = trials.run_trials(park3, n_trials=TR_PALLAS_N,
                               engine=EngineConfig(engine="pallas", tile=TILE),
                               run=RunConfig(length=SIDE, height=SIDE,
                                             mcs=TR_PALLAS_MCS,
                                             chunk_mcs=TR_PALLAS_MCS),
                               stop_on_stasis=False)
    pallas_trials_s = time.perf_counter() - t0
    launches["trials_pallas"] = counted = ops.launches()
    check(counted["escg_tile_round_trials"] == TR_PALLAS_MCS
          and counted["density_counts_trials"] == TR_PALLAS_MCS + 1
          and counted["escg_tile_round"] == 0
          and counted["density_counts"] == 0,
          f"the pallas trials did not run one K3 and one K4 launch per MCS "
          f"for all trials: {counted}")
    check(rolls["trials_pallas"] == 0, f"the pallas trials rolled the "
          f"lattices outside K3 ({rolls['trials_pallas']} torch.roll calls)")
    check(sorted(rp.observables) == ["densities", "interface_length"]
          and rp.observables["interface_length"].shape
          == (TR_PALLAS_N, TR_PALLAS_MCS, 1), f"the pallas trials streamed "
          f"{sorted(rp.observables)}")
    grids_p, keys_p = trials.trial_grids_and_keys(
        p_pal, threefry.PRNGKey(p_pal.seed), TR_PALLAS_N, dev)
    chunk, pipe = trials.build_trial_obs_chunk(
        p_pal, engines.build(p_pal, dom_park3, dev))
    ring = obs.ring_init(TR_PALLAS_MCS, (TR_PALLAS_N, pipe.width), dev)[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chunk(grids_p, keys_p, ring, 0, TR_PALLAS_MCS)
    torch.cuda.synchronize()
    pallas_batch_ms = (time.perf_counter() - t0) / TR_PALLAS_MCS * 1e3
    t0 = time.perf_counter()
    for t in range(TR_PALLAS_N):
        s1 = simulate(p_pal, dom_park3, grid0=grids_p[t], key=keys_p[t],
                      stop_on_stasis=False, device=dev)
        check(np.array_equal(rp.densities[t], s1.densities[-1])
              and np.array_equal(rp.observables["densities"][t],
                                 s1.densities[1:])
              and np.array_equal(rp.observables["interface_length"][t],
                                 s1.observables["interface_length"]),
              f"pallas trial {t} differs from its single-lattice run")
    singles_s = time.perf_counter() - t0
    print(f"[trials/pallas] park3 {SIDE}x{SIDE} {TR_PALLAS_N} trials "
          f"{TR_PALLAS_MCS} MCS with park3's observables: "
          f"{pallas_trials_s:.3f}s incl. set-up; one chunk of "
          f"build_trial_obs_chunk {pallas_batch_ms:.2f} ms/MCS for the "
          f"batch, {pallas_batch_ms / TR_PALLAS_N:.2f} per trial; "
          f"{TR_PALLAS_N} single pallas runs {singles_s:.3f}s incl. set-up "
          f"({singles_s / TR_PALLAS_N / TR_PALLAS_MCS * 1e3:.2f} ms/MCS "
          f"each); "
          f"launches {counted}; torch.roll calls {rolls['trials_pallas']}; "
          f"each trial equals its single-lattice run (final densities, the "
          f"densities and interface_length streams); {card}")
    g8t = g16[:TR_PALLAS_N]
    shifts8 = shifts16[:TR_PALLAS_N]
    props8t = [rng.tile_stream_batch(keys_p[t].to(dev), tile_ids, k,
                                     interior, 4)
               for t in range(TR_PALLAS_N)]
    props8t = [torch.stack(f) for f in zip(*props8t)]
    k3t_ms = event_ms(torch, lambda: escg_update.escg_tile_round_trials(
        g8t, *props8t, dom, dirs, TILE, te, tem, shifts8), 10)
    k3n_ms = event_ms(torch, lambda: [escg_update.escg_tile_round(
        g8t[t], *(f[t] for f in props8t), dom, dirs, TILE, te, tem,
        (th - 1, tw - 1)) for t in range(TR_PALLAS_N)], 5)
    k3t_plain, _ = once_ms(
        torch, lambda: escg_update.escg_tile_round_trials_plain(
            g8t, *props8t, dom, TILE, te, tem, shifts8))
    del props8t
    print(f"[time] K3 over {TR_PALLAS_N} trials at {SIDE}x{SIDE}: "
          f"{k3t_ms:.4f} ms per launch against {k3n_ms:.4f} for "
          f"{TR_PALLAS_N} single launches (one {k3_ms:.4f}); plain "
          f"{k3t_plain:.1f} ms; bound {TR_PALLAS_N} x {k3_bound * 1e3:.1f} "
          f"us; {card}")

    # ---- 23. [trials/park] Park's eight species on the default engine ----
    prob = make_scenario("probabilistic")

    def park_run(n_tr, mcs, chunk, hooks=(), device=None):
        return trials.run_trials(
            prob, n_trials=n_tr,
            run=RunConfig(length=PARK_SIDE, height=PARK_SIDE, mcs=mcs,
                          chunk_mcs=chunk),
            stop_on_stasis=False, hooks=hooks, device=device)

    ops.reset_launches()
    t0 = time.perf_counter()
    rk = park_run(PARK_N, PARK_MCS, PARK_CHUNK)
    park_wall = time.perf_counter() - t0
    launches["trials_park"] = counted = ops.launches()
    check(counted["density_counts_trials"] == PARK_MCS + 1
          and sum(counted.values()) == PARK_MCS + 1,
          f"the Park trials ran other kernels than K4 per trial: {counted}")
    check(rk.densities.shape == (PARK_N, 9) and rk.mcs_completed == PARK_MCS
          and np.abs(rk.densities.sum(axis=1) - 1.0).max() < 1e-12
          and 0.0 < rk.kept_fraction < 1.0 and not rk.observables
          and rk.survivors_hist().shape == (9,)
          and abs(rk.survivors_hist().sum() - 1.0) < 1e-12,
          f"the Park trials' result is malformed (kept_fraction "
          f"{rk.kept_fraction})")
    print(f"[trials/park] probabilistic (8 species, alpha 0.15, beta 0.75, "
          f"gamma 1) {PARK_N} trials {PARK_SIDE}x{PARK_SIDE} {PARK_MCS} MCS "
          f"on batched: {park_wall:.3f}s incl. set-up "
          f"({park_wall / PARK_MCS * 1e3:.2f} ms/MCS, "
          f"{park_wall / PARK_MCS / PARK_N * 1e3:.3f} per trial); launches "
          f"{counted}; kept_fraction {rk.kept_fraction!r}; "
          f"survival probabilities {rk.survival_probabilities().tolist()}; "
          f"survivors histogram {rk.survivors_hist().tolist()}; {card}")
    p_park = compose(prob, EngineConfig(),
                     RunConfig(length=PARK_SIDE, height=PARK_SIDE))
    built_park = engines.build(p_park, prob.dominance(), dev)
    per_mcs = {}
    for n_tr in (8, PARK_N):
        grids_k, keys_k = trials.trial_grids_and_keys(
            p_park, threefry.PRNGKey(0), n_tr, dev)
        chunk = trials.build_trial_chunk(p_park, built_park)
        chunk(grids_k, keys_k, 1)                       # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chunk(grids_k, keys_k, PARK_COUNT_MCS)
        torch.cuda.synchronize()
        untraced = (time.perf_counter() - t0) / PARK_COUNT_MCS * 1e3
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            chunk(grids_k, keys_k, PARK_COUNT_MCS)
            torch.cuda.synchronize()
            traced = (time.perf_counter() - t0) / PARK_COUNT_MCS * 1e3
        kernels = busy = 0.0
        for evt in prof.key_averages():
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                kernels += evt.count
                busy += float(getattr(evt, "self_device_time_total", 0.0)
                              or getattr(evt, "self_cuda_time_total", 0.0))
        per_mcs[n_tr] = (kernels / PARK_COUNT_MCS,
                         busy / PARK_COUNT_MCS / 1e3, traced, untraced)
    (c8, b8, w8, u8), (c64, b64, w64, u64) = per_mcs[8], per_mcs[PARK_N]
    print(f"[trials/park] build_trial_chunk, {PARK_COUNT_MCS} MCS: "
          f"{u8:.3f} ms/MCS at 8 trials and {u64:.3f} at {PARK_N} "
          f"({u64 / PARK_N:.4f} per trial); device launches per MCS by the "
          f"profiler {c8:.1f} and {c64:.1f}; device busy {b8:.3f} and "
          f"{b64:.3f} ms/MCS of traced walls {w8:.3f} and {w64:.3f} (idle "
          f"{1 - b8 / w8:.3f} and {1 - b64 / w64:.3f}); {card}")
    check(c8 > 0 and abs(c64 - c8) <= 0.05 * c8,
          f"batched's launches per MCS grew with the trials: {c8} at 8, "
          f"{c64} at {PARK_N}")
    on_card = park_run(PARK_N, PARK_CPU_MCS, PARK_CPU_MCS)
    on_host = park_run(PARK_CPU_N, PARK_CPU_MCS, PARK_CPU_MCS, device="cpu")
    for field_name in ("survival", "densities", "stasis_mcs",
                       "extinction_mcs"):
        check(np.array_equal(getattr(on_card, field_name)[:PARK_CPU_N],
                             getattr(on_host, field_name)),
              f"the first {PARK_CPU_N} Park trials on the card differ from "
              f"the CPU in {field_name}")
    print(f"[trials/park] the first {PARK_CPU_N} of {PARK_N} trials on the "
          f"card equal {PARK_CPU_N} trials on the CPU for {PARK_CPU_MCS} MCS "
          f"(survival, densities, stasis and extinction MCS)")

    # ---- 24. [trials/golden] the trial golden on the card ----
    with open(TRIAL_GOLDEN) as f:
        want = json.load(f)
    for engine in ("sublattice", "pallas"):
        ops.reset_launches()
        r = trials.run_trials(
            make_scenario("nspecies5", mobility=1e-3, empty=0.1),
            dominance.RPSLS(), n_trials=4,
            engine=EngineConfig(engine=engine, tile=(8, 8)),
            run=RunConfig(length=16, height=16, seed=7, observables=()),
            n_mcs=6, chunk_mcs=3, stop_on_stasis=False, device=dev)
        counted = ops.launches()
        check(json.loads(r.to_json()) == want,
              f"the trial golden differs on {engine}")
        check(counted["density_counts_trials"] == 7
              and counted["escg_tile_round_trials"]
              == (6 if engine == "pallas" else 0),
              f"the trial golden on {engine} launched {counted}")
    print("[golden] tests/golden/trial_result.json reproduced on the card "
          "through run_trials on sublattice and on pallas (K3 over the 4 "
          "trials)")

    # ---- 25. [sharded_pod] the composed pod x grid mesh on one card ----
    n_pod = POD_MESH[0] * POD_MESH[1] * POD_MESH[2]
    pod_devs = ["cuda:0"] * n_pod

    def pod_trials(n_tr, mcs, mesh_shape, local_kernel, key, observables=(),
                   side=SIDE, k_mcs=1, engine="sharded_pod", device=None):
        """``run_trials`` of park3 with the launch and roll counts."""
        kw = dict(mesh_shape=mesh_shape, local_kernel=local_kernel) \
            if engine == "sharded_pod" else {}
        ops.reset_launches()
        t0 = time.perf_counter()
        with counted_rolls(torch, rolls, key):
            r = trials.run_trials(
                park3, n_trials=n_tr,
                engine=EngineConfig(engine=engine, tile=TILE, k_mcs=k_mcs,
                                    **kw),
                run=RunConfig(length=side, height=side, mcs=mcs,
                              chunk_mcs=mcs, observables=observables),
                stop_on_stasis=False, device=device)
        launches[key] = ops.launches()
        return r, time.perf_counter() - t0

    def same_trials(a, b):
        da, db = json.loads(a.to_json()), json.loads(b.to_json())
        da.pop("n_devices"), db.pop("n_devices")
        return da == db

    # (a) fused, 16 trials on (2, 2, 2) of eight cuda:0 entries
    pod_f, pod_f_s = pod_trials(POD_N, POD_MCS, POD_MESH, "fused",
                                "pod_fused", device=pod_devs)
    pod_twin, _ = pod_trials(POD_N, POD_MCS, None, None, "pod_twin",
                             engine="pallas_fused", device=dev)
    counted = launches["pod_fused"]
    check(counted["escg_tile_round_fused_table"] == POD_MCS
          and counted["density_counts_sharded_trials"] == POD_MCS + 1
          and sum(counted.values()) == 2 * POD_MCS + 1,
          f"sharded_pod/fused did not run one K1 table launch and one K4s "
          f"per-trial launch per MCS for all {POD_N} trials: {counted}")
    check(rolls["pod_fused"] == 0, f"sharded_pod/fused rolled a lattice "
          f"({rolls['pod_fused']} torch.roll calls)")
    check(same_trials(pod_f, pod_twin) and pod_f.n_devices == n_pod
          and pod_f.densities.shape == (POD_N, 4)
          and np.abs(pod_f.densities.sum(axis=1) - 1.0).max() < 1e-12,
          "sharded_pod/fused differs from pallas_fused's trials")
    print(f"[sharded_pod] (a) fused park3 {SIDE}x{SIDE}, {POD_N} trials on a "
          f"{POD_MESH} mesh of cuda:0, {POD_MCS} MCS: every trial equals "
          f"pallas_fused's (survival, densities, stasis and extinction MCS, "
          f"kept_fraction); launches {counted}; torch.roll calls "
          f"{rolls['pod_fused']}; {pod_f_s:.3f}s incl. set-up; {card}")

    # (b) fused on (4, 1, 1) with k_mcs=10: K2's trial form per pod group
    pod_k, _ = pod_trials(POD_N, POD_MCS, (4, 1, 1), "fused", "pod_fused_k10",
                          k_mcs=K_MCS, device=["cuda:0"] * 4)
    counted = launches["pod_fused_k10"]
    check(counted["escg_tile_rounds_fused_trials"] == 4 * (POD_MCS // K_MCS)
          and counted["density_counts_sharded_trials"] == 1
          and counted["escg_tile_round_fused_table"] == 0,
          f"sharded_pod/fused (4, 1, 1) k_mcs={K_MCS} did not run K2's trial "
          f"form once per pod group: {counted}")
    check(same_trials(pod_k, pod_twin), f"sharded_pod/fused (4, 1, 1) "
          f"k_mcs={K_MCS} differs from pallas_fused at k_mcs=1")
    print(f"[sharded_pod] (b) fused on (4, 1, 1) at k_mcs={K_MCS}: equals "
          f"(a)'s oracle; launches {counted}")

    # (c) pallas, 8 trials with park3's declared observables
    pod_p, pod_p_s = pod_trials(POD_PALLAS_N, POD_PALLAS_MCS, POD_MESH,
                                "pallas", "pod_pallas", observables=None,
                                device=pod_devs)
    pod_p_twin, _ = pod_trials(POD_PALLAS_N, POD_PALLAS_MCS, None, None,
                               "pod_pallas_twin", observables=None,
                               engine="pallas", device=dev)
    counted = launches["pod_pallas"]
    check(counted["escg_tile_round_table"] == POD_PALLAS_MCS
          and counted["density_counts_sharded_trials"] == POD_PALLAS_MCS + 1
          and counted["escg_tile_round"] == 0
          and counted["escg_tile_round_trials"] == 0,
          f"sharded_pod/pallas did not run one K3 table launch per MCS: "
          f"{counted}")
    check(rolls["pod_pallas"] == 0, f"sharded_pod/pallas rolled a lattice "
          f"({rolls['pod_pallas']} torch.roll calls)")
    check(same_trials(pod_p, pod_p_twin)
          and sorted(pod_p.observables) == ["densities", "interface_length"],
          "sharded_pod/pallas differs from pallas's trials")
    print(f"[sharded_pod] (c) pallas, {POD_PALLAS_N} trials, {POD_PALLAS_MCS} "
          f"MCS with park3's observables: every trial and every densities "
          f"and interface_length row equals pallas's; launches {counted}; "
          f"torch.roll calls {rolls['pod_pallas']}; {pod_p_s:.3f}s incl. "
          f"set-up")

    # (d) jnp at 256 x 256, held to pallas
    small = [pod_trials(POD_PALLAS_N, POD_PALLAS_MCS, POD_MESH, lk,
                        f"pod_{lk}_small", observables=None, side=JNP_SIDE,
                        device=pod_devs)[0] for lk in ("jnp", "pallas")]
    check(same_trials(*small), "sharded_pod/jnp differs from pallas")
    print(f"[sharded_pod] (d) jnp at {JNP_SIDE}x{JNP_SIDE}: equals pallas, "
          f"trials and observables; launches {launches['pod_jnp_small']}")

    # (e) the default mesh on one card: every visible card on the pod axis
    pod_e, _ = pod_trials(4, 3, None, "fused", "pod_default")
    twin_e, _ = pod_trials(4, 3, None, None, "pod_default_twin",
                           engine="pallas_fused", device=dev)
    check(same_trials(pod_e, twin_e) and pod_e.n_devices == 1,
          f"sharded_pod with mesh_shape=None differs from pallas_fused "
          f"({pod_e.n_devices} devices)")
    print(f"[sharded_pod] (e) mesh_shape=None on one card is (1, 1, 1): "
          f"equals pallas_fused; launches {launches['pod_default']}")

    # (f) simulate on pod group 0's grid, held to sharded
    sims = {}
    for eng, kw, devs in (
            ("sharded_pod", dict(mesh_shape=POD_MESH), pod_devs),
            ("sharded", dict(shard_grid=POD_MESH[1:]),
             ["cuda:0"] * (POD_MESH[1] * POD_MESH[2]))):
        sims[eng] = simulate(park3, engine=EngineConfig(
            engine=eng, tile=TILE, local_kernel="fused", **kw),
            run=RunConfig(length=SIDE, height=SIDE, mcs=POD_MCS,
                          chunk_mcs=POD_MCS, observables=()), device=devs)
    check(np.array_equal(sims["sharded_pod"].grid, sims["sharded"].grid)
          and np.array_equal(sims["sharded_pod"].densities,
                             sims["sharded"].densities),
          "simulate on sharded_pod differs from sharded")
    print(f"[sharded_pod] (f) simulate(engine='sharded_pod') equals sharded "
          f"on {POD_MESH[1:]}: final lattice and {POD_MCS + 1} density rows")

    # (g) the new forms at the staging's edges, against their plain versions
    def table_case(i, dtype, tile):
        """Runs of (n, sh, sw) labels 0..5 with halos on the axes the case
        gives, and each trial's shifts: 0 and tile - 1 on an axis with a
        halo, also H - 1 and W - 1 without one."""
        (h, w), (th, tw) = POD_EDGE_BLOCK, tile
        n_runs, n = POD_EDGE_RUNS[i % 3], TR_EDGE_NS[(i // 3) % 3]
        halo = ((True, True), (True, False), (False, True),
                (False, False))[i % 4]
        sh, sw = h + (th if halo[0] else 0), w + (tw if halo[1] else 0)
        gen = torch.Generator(dev).manual_seed(i)
        sources = [torch.randint(0, 6, (n, sh, sw), device=dev,
                                 generator=gen, dtype=torch.int32).to(dtype)
                   for _ in range(n_runs)]
        rows = [0, th - 1, 1] + ([] if halo[0] else [h - 1])
        cols = [0, tw - 1, 1] + ([] if halo[1] else [w - 1])
        shifts = [torch.tensor([(rows[(r + t) % len(rows)],
                                 cols[(r + 2 * t) % len(cols)])
                                for t in range(n)], dtype=torch.int64,
                               device=dev) for r in range(n_runs)]
        return sources, shifts, n_runs, n

    t1_err = t3_err = t4_err = 0.0
    edge_cases_g = list(itertools.product(
        (torch.int8, torch.int16, torch.int32), EDGE_TILES))
    for i, (dtype, tile) in enumerate(edge_cases_g):
        nbhd = (4, 8)[i % 2]
        sources, shifts, n_runs, n = table_case(i, dtype, tile)
        k_edge = tile[0] * tile[1] - (7 if i % 2 else 0)
        words3 = ((0, 2 ** 32 - 1), (2 ** 32 - 1, 5), (11, 12))
        seeds_g = [torch.tensor([words3[(r + t) % 3] for t in range(n)],
                                dtype=torch.int64, device=dev)
                   for r in range(n_runs)]
        offs = [(3 * r, 2 * r + 1) for r in range(n_runs)]
        gw = 3 * POD_EDGE_BLOCK[1] // tile[1] + 5
        a = fused.escg_tile_round_fused_table(
            sources, seeds_g, shifts, offs, POD_EDGE_BLOCK, dom5, dirs, tile,
            k_edge, 0.25, 0.6, nbhd, gw)
        b = fused.escg_tile_round_fused_table_plain(
            sources, seeds_g, shifts, offs, POD_EDGE_BLOCK, dom5, tile,
            k_edge, 0.25, 0.6, nbhd, gw)
        n_block = (POD_EDGE_BLOCK[0] // tile[0]) * (POD_EDGE_BLOCK[1]
                                                    // tile[1])
        props_g = [rng.tile_stream_batch(
            threefry.split(threefry.PRNGKey(60 + i + r), n).to(dev),
            torch.arange(n_block, device=dev) + 11 * r, k_edge,
            (tile[0] - 2) * (tile[1] - 2), nbhd) for r in range(n_runs)]
        c = escg_update.escg_tile_round_table(
            sources, props_g, shifts, POD_EDGE_BLOCK, dom5, dirs, tile,
            0.25, 0.6)
        d = escg_update.escg_tile_round_table_plain(
            sources, props_g, shifts, POD_EDGE_BLOCK, dom5, tile, 0.25, 0.6)
        groups_g = [sources[r:r + 2] for r in range(0, n_runs, 2)]
        e = density.density_counts_sharded_trials(groups_g, 5)
        f = density.density_counts_sharded_trials_plain(groups_g, 5)
        torch.cuda.synchronize()
        t1_err = max([t1_err] + [max_err(torch, x, y) for x, y in zip(a, b)])
        t3_err = max([t3_err] + [max_err(torch, x, y) for x, y in zip(c, d)])
        t4_err = max(t4_err, max_err(torch, e, f))
    print(f"[sharded_pod] (g) K1's and K3's table forms and K4s per trial at "
          f"{len(edge_cases_g)} edge cases (blocks of {POD_EDGE_BLOCK}; int8, "
          f"int16, int32; tiles {EDGE_TILES}; nbhd 4, 8; {POD_EDGE_RUNS} runs "
          f"of {TR_EDGE_NS} trials; halos on both axes, one and none; shifts "
          f"0 and tile - 1, and H - 1, W - 1 without a halo; K = th*tw and "
          f"th*tw - 7): max_abs_err K1 {t1_err}, K3 {t3_err}, K4s {t4_err} "
          f"against their plain versions")
    check(t1_err == 0.0 and t3_err == 0.0 and t4_err == 0.0,
          f"the table forms disagree with their plain versions: K1 "
          f"{t1_err}, K3 {t3_err}, K4s per trial {t4_err}")

    # times: the batch's MCS, and each new form against the launches it
    # replaces, its plain version and its bound, on (a)'s lattices
    p_pod = compose(park3, EngineConfig(engine="sharded_pod", tile=TILE,
                                        mesh_shape=POD_MESH,
                                        local_kernel="fused"),
                    RunConfig(length=SIDE, height=SIDE, observables=()))
    built_pod = engines.build(p_pod, dom_park3, pod_devs)
    batch, keys_pod = built_pod.init_batch(
        trials.fold_trial_keys(threefry.PRNGKey(0), POD_N))
    chunk_pod = trials.build_trial_chunk(p_pod, built_pod)
    p_fus = p_pod.replace(engine="pallas_fused", mesh_shape=None)
    built_fus = engines.build(p_fus, dom_park3, dev)
    grids_fus, keys_fus = trials.trial_grids_and_keys(
        p_fus, threefry.PRNGKey(0), POD_N, dev)
    chunk_fus = trials.build_trial_chunk(p_fus, built_fus)
    per_mcs = {}
    for label, ch, state, kk in (("sharded_pod", chunk_pod, batch, keys_pod),
                                 ("pallas_fused", chunk_fus, grids_fus,
                                  keys_fus),
                                 ("sharded_pod ", chunk_pod, batch,
                                  keys_pod)):
        ch(state, kk, 1)                                 # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ch(state, kk, POD_MCS)
        torch.cuda.synchronize()
        per_mcs.setdefault(label.strip(), []).append(
            (time.perf_counter() - t0) / POD_MCS * 1e3)
    print(f"[sharded_pod] build_trial_chunk of {POD_N} trials at "
          f"{SIDE}x{SIDE}, {POD_MCS} MCS after a warm-up (the host key chain "
          f"included): sharded_pod/fused on {POD_MESH} of cuda:0 "
          f"{per_mcs['sharded_pod']} ms/MCS for the batch "
          f"({[round(x / POD_N, 4) for x in per_mcs['sharded_pod']]} per "
          f"trial); pallas_fused {per_mcs['pallas_fused']} "
          f"({[round(x / POD_N, 4) for x in per_mcs['pallas_fused']]} per "
          f"trial); {card}")

    th_, tw_ = TILE
    blocks_h, blocks_w = SIDE // POD_MESH[1], SIDE // POD_MESH[2]
    lgh, lgw = blocks_h // th_, blocks_w // tw_
    exts = [sharded.halo_extend(g, TILE) for g in batch.groups]
    runs_pod = [(g, ri, ci) for g in range(POD_MESH[0])
                for ri in range(POD_MESH[1]) for ci in range(POD_MESH[2])]
    n_g = POD_N // POD_MESH[0]
    srcs = [exts[g][ri][ci] for g, ri, ci in runs_pod]
    seeds_pod = [keys_pod[g * n_g:(g + 1) * n_g].to(dev)
                 for g, _, _ in runs_pod]
    # each trial's own shift: tile - 1 and the ones below it on the rows,
    # tile - 1 and 0 in turn on the columns
    shifts_pod = [torch.tensor([[th_ - 1 - t % th_, (tw_ - 1) * (1 - t % 2)]
                                for t in range(n_g)], dtype=torch.int64,
                               device=dev) for _ in runs_pod]
    offs_pod = [(ri * lgh, ci * lgw) for _, ri, ci in runs_pod]
    blk = (blocks_h, blocks_w)

    def k1_table():
        return fused.escg_tile_round_fused_table(
            srcs, seeds_pod, shifts_pod, offs_pod, blk, dom, dirs, TILE, k,
            te, tem, 4, SIDE // tw_)

    def k1_per_block():
        # the launches the table replaces: K1 on each block of each trial
        return [fused.escg_tile_round_fused(
            batch.groups[g].blocks[ri][ci][t], (1, 2), 0, dom, dirs, TILE,
            k, te, tem, 4, (ri * lgh, ci * lgw), SIDE // tw_)
            for g, ri, ci in runs_pod for t in range(n_g)]
    k1_tab_ms = event_ms(torch, k1_table, 10)
    k1_blk_ms = event_ms(torch, k1_per_block, 3)
    k1_tab_plain, plain_out = once_ms(
        torch, lambda: fused.escg_tile_round_fused_table_plain(
            srcs, seeds_pod, shifts_pod, offs_pod, blk, dom, TILE, k, te,
            tem, 4, SIDE // tw_))
    # the table at the main path's shapes, held to its plain version
    pod_t1_err = max(max_err(torch, x, y)
                     for x, y in zip(k1_table(), plain_out))
    del plain_out
    # each trial's window of its block is read once and written once (the
    # halo extension is a pass of its own, timed below)
    pod_cell_bytes = srcs[0].element_size() * SIDE * SIDE
    k1_tab_bound, k1_tab_by = bound(
        2 * POD_N * pod_cell_bytes
        + sum(x.numel() * x.element_size() for x in seeds_pod + shifts_pod),
        POD_N * updates * OPS_PER_UPDATE)
    halo_ms = event_ms(torch, lambda: [sharded.halo_extend(g, TILE)
                                       for g in batch.groups], 10)

    n_p = POD_PALLAS_N // POD_MESH[0]
    props_pod = [rng.tile_stream_batch(
        keys_pod[:n_p].to(dev),
        sharded._local_tile_ids(ri, ci, blk, TILE, SIDE // tw_, dev), k,
        interior, 4) for _, ri, ci in runs_pod]
    srcs_p = [x[:n_p] for x in srcs]
    shifts_p = [x[:n_p] for x in shifts_pod]

    def k3_table():
        return escg_update.escg_tile_round_table(
            srcs_p, props_pod, shifts_p, blk, dom, dirs, TILE, te, tem)

    def k3_per_block():
        # the launches the table replaces: K3 on each block of each trial
        return [escg_update.escg_tile_round(
            batch.groups[g].blocks[ri][ci][t],
            *(fld[t] for fld in props_pod[r]), dom, dirs, TILE, te, tem)
            for r, (g, ri, ci) in enumerate(runs_pod) for t in range(n_p)]
    k3_tab_ms = event_ms(torch, k3_table, 10)
    k3_blk_ms = event_ms(torch, k3_per_block, 3)
    k3_tab_plain, plain_out = once_ms(
        torch, lambda: escg_update.escg_tile_round_table_plain(
            srcs_p, props_pod, shifts_p, blk, dom, TILE, te, tem))
    pod_t3_err = max(max_err(torch, x, y)
                     for x, y in zip(k3_table(), plain_out))
    del plain_out
    k3_tab_bound, k3_tab_by = bound(
        2 * POD_PALLAS_N * pod_cell_bytes + 16 * POD_PALLAS_N * updates
        + sum(x.numel() * x.element_size() for x in shifts_p),
        POD_PALLAS_N * updates * OPS_PER_STREAM_UPDATE)
    del props_pod

    groups_pod = [g.flat for g in batch.groups]
    k4st_ms = event_ms(torch, lambda: density.density_counts_sharded_trials(
        groups_pod, 3), 50)
    k4st_device = profiled_ms(
        torch, lambda: density.density_counts_sharded_trials(groups_pod, 3),
        50, "density_kernel")
    k4st_before = event_ms(torch, lambda: torch.stack([
        density.density_counts_sharded([b[t] for b in blocks], 3)
        for blocks in groups_pod for t in range(n_g)]), 10)
    k4st_plain = event_ms(
        torch, lambda: density.density_counts_sharded_trials_plain(
            groups_pod, 3), 3)
    pod_t4_err = max_err(
        torch, density.density_counts_sharded_trials(groups_pod, 3),
        density.density_counts_sharded_trials_plain(groups_pod, 3))
    trial_off = [(g * n_g + torch.arange(n_g, device=dev))[:, None, None] * 4
                 for g in range(POD_MESH[0])]

    def k4st_library():
        return torch.bincount(torch.cat([
            (b.long() + trial_off[g]).reshape(-1)
            for g, blocks in enumerate(groups_pod) for b in blocks]),
            minlength=POD_N * 4).view(POD_N, 4)
    check(torch.equal(k4st_library().int(),
                      density.density_counts_sharded_trials(groups_pod, 3)),
          "the offset bincount differs from K4s per trial")
    k4st_lib = event_ms(torch, k4st_library, 10)
    k4st_bound, k4st_by = bound(POD_N * pod_cell_bytes + POD_N * 4 * 4,
                                POD_N * SIDE * SIDE * OPS_PER_COUNTED_CELL)
    print(f"[time] K1 table over {len(runs_pod)} blocks x {n_g} trials "
          f"({POD_MESH}, blocks {blk} with their halo): {k1_tab_ms:.4f} ms "
          f"per launch against {k1_blk_ms:.4f} for the "
          f"{len(runs_pod) * n_g} per-block launches it replaces; plain "
          f"{k1_tab_plain:.1f} ms; bound {k1_tab_bound * 1e3:.1f} us by "
          f"{k1_tab_by}, {k1_tab_bound / k1_tab_ms:.3f} of the bound's time; "
          f"the halo extension of all blocks {halo_ms:.4f} ms; {card}")
    print(f"[time] K3 table over {len(runs_pod)} blocks x {n_p} trials: "
          f"{k3_tab_ms:.4f} ms per launch against {k3_blk_ms:.4f} for the "
          f"{len(runs_pod) * n_p} per-block launches (on the blocks' "
          f"unshifted cells); plain {k3_tab_plain:.1f} ms; bound "
          f"{k3_tab_bound * 1e3:.1f} us by {k3_tab_by}, "
          f"{k3_tab_bound / k3_tab_ms:.3f} of the bound's time; {card}")
    print(f"[time] K4s per trial over {POD_N} trials in {len(runs_pod)} "
          f"blocks: {k4st_ms:.4f} ms per launch, device time by the profiler "
          f"{k4st_device}, against {k4st_before:.4f} for one K4s launch per "
          f"trial; plain {k4st_plain:.3f} ms; bound "
          f"{k4st_bound * 1e3:.1f} us by {k4st_by}; library call (one "
          f"torch.bincount of the blocks' labels offset by t x (S+1), their "
          f"int64 copies included) {k4st_lib:.4f} ms; {card}")
    print(f"[sharded_pod] the table forms at the main path's shapes "
          f"({POD_MESH}, blocks {blk} with their halo, {n_g} trials a run "
          f"for K1 and K4s, {n_p} for K3, each trial at its own shift): "
          f"max_abs_err K1 {pod_t1_err}, K3 {pod_t3_err}, K4s per trial "
          f"{pod_t4_err} against their plain versions")
    check(pod_t1_err == 0.0 and pod_t3_err == 0.0 and pod_t4_err == 0.0,
          f"the table forms disagree with their plain versions at the main "
          f"path's shapes: K1 {pod_t1_err}, K3 {pod_t3_err}, K4s per trial "
          f"{pod_t4_err}")
    t1_err, t3_err = max(t1_err, pod_t1_err), max(t3_err, pod_t3_err)
    t4_err = max(t4_err, pod_t4_err)

    # ---- 26. [cli] the port's CLI as a user starts it ----
    # a subprocess of `python -m repro_torch.launch.escg_run` per run, park3
    # at SIDE on pallas_fused, each held to the same run in this process
    from repro_torch.core import io as io_mod
    from repro_torch.core.scenarios import decompose
    work = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.join(HERE, "src") + os.pathsep
                         + env.get("PYTHONPATH", ""))
    main_args = ["--scenario", "park3", "--length", str(SIDE), "--height",
                 str(SIDE), "--engine", "pallas_fused", "--tile",
                 str(TILE[0]), str(TILE[1]), "--chunkMcs", str(CLI_CHUNK),
                 "--printLaunches"]

    def cli_run(args, tag):
        """(stdout, wall s, the run's kernel launches, its ms/MCS)."""
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.escg_run", *args],
            capture_output=True, text=True, timeout=600, env=env, cwd=HERE)
        wall = time.perf_counter() - t0
        check(out.returncode == 0, f"[cli] {tag} exited {out.returncode}:\n"
              f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
        counts, ms_mcs = None, None
        for line in out.stdout.splitlines():
            if line.startswith("[escg] kernel launches "):
                counts = json.loads(line[len("[escg] kernel launches "):])
            m = re.search(r"(\d+) MCS in [\d.]+s \(([\d.e+-]+) updates/s",
                          line)
            if m:
                ms_mcs = SIDE * SIDE / float(m.group(2)) * 1e3
        return out.stdout, wall, counts, ms_mcs

    def saved(d):
        with np.load(os.path.join(d, "state.npz")) as z:
            return z["grid"], int(z["mcs"])

    def densities_csv(hist):
        path = os.path.join(work, "want_densities.csv")
        io_mod.export_densities_csv(path, hist)
        with open(path, "rb") as f:
            return f.read()

    def file_bytes(d, name):
        with open(os.path.join(d, name), "rb") as f:
            return f.read()

    def save_s(stdout):
        m = re.search(r"saved to .* in ([\d.]+)s", stdout)
        return float(m.group(1)) if m else float("nan")

    # (a) 20 MCS with --save, against simulate in this process
    dir_a = os.path.join(work, "a")
    out_a, wall_a, counts_a, ms_a = cli_run(
        main_args + ["--mcs", str(CLI_MCS), "--save", "true", "--outDir",
                     dir_a], "(a)")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref_a = simulate(park3, engine=EngineConfig(engine="pallas_fused",
                                                tile=TILE),
                     run=RunConfig(length=SIDE, height=SIDE, mcs=CLI_MCS,
                                   chunk_mcs=CLI_CHUNK), device=dev)
    inproc_ms = (time.perf_counter() - t0) / CLI_MCS * 1e3
    grid_a, mcs_a = saved(dir_a)
    check(mcs_a == CLI_MCS and np.array_equal(grid_a, ref_a.grid)
          and file_bytes(dir_a, "densities.csv")
          == densities_csv(ref_a.densities),
          "[cli] (a) the CLI's saved lattice or densities differ from "
          "simulate in this process")
    check(counts_a["escg_tile_round_fused"] == CLI_MCS
          and counts_a["density_counts"] == CLI_MCS + 1
          and sum(counts_a.values()) == 2 * CLI_MCS + 1,
          f"[cli] (a) did not run through K1 and K4: {counts_a}")
    print(f"[cli] (a) park3 {SIDE}x{SIDE} pallas_fused --mcs {CLI_MCS} "
          f"--save: state.npz grid and densities.csv equal simulate's; "
          f"launches K1 {counts_a['escg_tile_round_fused']}, K4 "
          f"{counts_a['density_counts']}; the process {wall_a:.2f}s, its "
          f"run {ms_a:.4f} ms/MCS against {inproc_ms:.4f} in this process; "
          f"save {save_s(out_a):.3f}s; {card}")

    # (b) --resume to 30 MCS: the saved lattice, key fold_in(PRNGKey(0), 20);
    # a resumed run saves where the state was saved (params.csv's out_dir),
    # so (a)'s files are kept aside first
    dir_b = dir_a
    dir_a = os.path.join(work, "a_saved")
    shutil.copytree(dir_b, dir_a)
    out_b, wall_b, counts_b, ms_b = cli_run(
        ["--resume", "true", "--mcs", str(CLI_MCS + CLI_RESUME),
         "--outDir", dir_b, "--printLaunches"], "(b)")
    p_saved = io_mod.load_state(dir_a)[0]
    sc_b, eng_b, run_b = decompose(p_saved.replace(mcs=CLI_RESUME))
    ref_b = simulate(sc_b, park3.dominance(), grid0=grid_a,
                     key=threefry.fold_in(threefry.PRNGKey(0), CLI_MCS),
                     engine=eng_b, run=run_b, device=dev)
    grid_b, mcs_b = saved(dir_b)
    check(mcs_b == CLI_MCS + CLI_RESUME and np.array_equal(grid_b, ref_b.grid)
          and file_bytes(dir_b, "densities.csv")
          == densities_csv(ref_b.densities),
          "[cli] (b) the resumed run differs from simulate(grid0=saved, "
          "key=fold_in(PRNGKey(0), 20))")
    print(f"[cli] (b) --resume true --mcs {CLI_MCS + CLI_RESUME}: equals "
          f"simulate from the saved lattice and fold_in(PRNGKey(0), "
          f"{CLI_MCS}) for {CLI_RESUME} MCS; the process {wall_b:.2f}s, its "
          f"run {ms_b:.4f} ms/MCS")

    # (c) (a) with --kMcs 10: K2, the same files
    dir_c = os.path.join(work, "c")
    out_c, wall_c, counts_c, ms_c = cli_run(
        main_args + ["--mcs", str(CLI_MCS), "--save", "true", "--outDir",
                     dir_c, "--kMcs", str(K_MCS)], "(c)")
    same_c = all(file_bytes(dir_a, n) == file_bytes(dir_c, n)
                 for n in ("grid.csv", "densities.csv", "dominance.csv"))
    pa, pc = (json.loads(file_bytes(d, "params.csv")) for d in (dir_a, dir_c))
    for d in (pa, pc):
        d.pop("out_dir"), d.pop("k_mcs")
    check(same_c and pa == pc and np.array_equal(saved(dir_c)[0], grid_a),
          f"[cli] (c) --kMcs {K_MCS} wrote other files than (a)")
    check(counts_c["escg_tile_rounds_fused"] == CLI_MCS // K_MCS
          and counts_c["escg_tile_round_fused"] == 0
          and counts_c["density_counts"] == 1,
          f"[cli] (c) did not run through K2: {counts_c}")
    print(f"[cli] (c) --kMcs {K_MCS}: grid.csv, densities.csv, state.npz "
          f"equal (a)'s; launches K2 {counts_c['escg_tile_rounds_fused']}, "
          f"K4 {counts_c['density_counts']}; the process {wall_c:.2f}s, its "
          f"run {ms_c:.4f} ms/MCS; save {save_s(out_c):.3f}s")

    # (d) --trials 8: trials.json equals a direct run_trials
    dir_d = os.path.join(work, "d")
    out_d, wall_d, counts_d, _ = cli_run(
        main_args + ["--mcs", str(CLI_TRIAL_MCS), "--trials",
                     str(CLI_TRIALS), "--save", "true", "--outDir", dir_d],
        "(d)")
    ref_d = trials.run_trials(
        park3, n_trials=CLI_TRIALS,
        engine=EngineConfig(engine="pallas_fused", tile=TILE),
        run=RunConfig(length=SIDE, height=SIDE, mcs=CLI_TRIAL_MCS,
                      chunk_mcs=CLI_CHUNK), device=dev)
    check(json.loads(file_bytes(dir_d, "trials.json"))
          == json.loads(ref_d.to_json()),
          "[cli] (d) trials.json differs from a direct run_trials")
    check(counts_d["escg_tile_round_fused_trials"] == CLI_TRIAL_MCS
          and counts_d["density_counts_trials"] == CLI_TRIAL_MCS + 1,
          f"[cli] (d) did not run K1 and K4 over the trials: {counts_d}")
    print(f"[cli] (d) --trials {CLI_TRIALS} --mcs {CLI_TRIAL_MCS}: "
          f"trials.json equals run_trials; launches {counts_d}; the process "
          f"{wall_d:.2f}s")

    # (e) the registry matrices against README.md
    out_e, wall_e, _, _ = cli_run(["--listEngines", "--listScenarios",
                                   "--check", "README.md"], "(e)")
    check("engine matrix matches" in out_e
          and "scenario matrix matches" in out_e,
          f"[cli] (e) the README check said: {out_e}")
    print(f"[cli] (e) --listEngines --listScenarios --check README.md: exit "
          f"0 ({wall_e:.2f}s)")
    shutil.rmtree(work, ignore_errors=True)

    # ---- 27. [serve] the scenario server on the card ----
    from repro_torch.serve import ScenarioServer, SimRequest
    from repro_torch.serve.httpd import serve_http
    srv = ScenarioServer(device="cuda:0")
    fused_eng = {"engine": "pallas_fused", "tile": list(TILE)}

    def sreq(seed, n, mcs, rid, engine=fused_eng):
        return SimRequest("park3", engine=engine,
                          run={"length": SIDE, "height": SIDE, "mcs": mcs,
                               "chunk_mcs": SRV_CHUNK, "seed": seed},
                          n_trials=n, id=rid)

    def direct(req, device="cuda:0"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = trials.run_trials(req.scenario, n_trials=req.n_trials,
                              engine=req.engine, run=req.run, device=device)
        return r, time.perf_counter() - t0

    def same_result(a, b):
        return json.loads(a.to_json()) == json.loads(b.to_json())

    wave = [sreq(seed, n, mcs, f"s{i}")
            for i, (seed, n, mcs) in enumerate(SRV_REQS)]
    n_batch = sum(n for _, n, _ in SRV_REQS)
    mcs_batch = max(mcs for _, _, mcs in SRV_REQS)
    trial_mcs = sum(n * mcs for _, n, mcs in SRV_REQS)
    builds0 = engines.BUILDS
    ops.reset_launches()
    resp1 = srv.serve(wave)
    launches["serve"] = counted = ops.launches()
    srv_builds = engines.BUILDS - builds0
    acct = srv.accounting()
    check(all(r.ok for r in resp1), f"[serve] a request failed: "
          f"{[r.error for r in resp1 if not r.ok]}")
    check(acct["batches"] == 1 and acct["packed_trials"] == n_batch,
          f"[serve] the three requests did not pack into one batch of "
          f"{n_batch} trials: {acct['batches']} batches, "
          f"{acct['packed_trials']} trials")
    check(counted["escg_tile_round_fused_trials"] == mcs_batch
          and counted["density_counts_trials"] == mcs_batch + 1
          and sum(counted.values()) == 2 * mcs_batch + 1,
          f"[serve] the batch did not run one K1 trial-form and one K4 "
          f"per-trial launch per MCS: {counted}")
    direct_s = 0.0
    for req, resp in zip(wave, resp1):
        ref, took = direct(req)
        direct_s += took
        check(same_result(resp.result, ref), f"[serve] {req.id} differs "
              f"from its direct run_trials")
    run_s = resp1[0].timing["run_s"]
    miss_s = resp1[0].timing["compile_s"]
    print(f"[serve] park3 {SIDE}x{SIDE} pallas_fused, requests of "
          f"{[n for _, n, _ in SRV_REQS]} trials x "
          f"{[m for _, _, m in SRV_REQS]} MCS: one batch of {n_batch} "
          f"trials, launches {counted}; every response equals its direct "
          f"run_trials; the batch {run_s:.3f}s = "
          f"{run_s / (n_batch * mcs_batch) * 1e3:.4f} ms per trial-MCS run "
          f"({run_s / trial_mcs * 1e3:.4f} per trial-MCS asked), the direct "
          f"runs {direct_s:.3f}s = {direct_s / trial_mcs * 1e3:.4f} ms per "
          f"trial-MCS; engine builds {srv_builds}; {card}")

    # the same requests again: cache hits, no engine built
    builds1 = engines.BUILDS
    wave2 = [dataclasses.replace(r, id=r.id + "-w2") for r in wave]
    resp2 = srv.serve(wave2)
    acct2 = srv.accounting()
    check(all(r.ok and r.cache_hit for r in resp2)
          and engines.BUILDS == builds1
          and acct2["cache"]["hits"] == acct["cache"]["hits"] + 1
          and acct2["cache"]["misses"] == acct["cache"]["misses"],
          f"[serve] the second wave was not answered from the cache "
          f"without a build: {acct2['cache']}, builds "
          f"{engines.BUILDS - builds1}")
    for a, b in zip(resp1, resp2):
        check(same_result(a.result, b.result), "[serve] the second wave's "
              "results differ from the first's")
    lat = acct2["latency"]["total"]
    print(f"[serve] second wave: {len(resp2)} cache hits, no engine built; "
          f"cache miss (the engine build; the kernels' libraries were "
          f"loaded by earlier phases) {miss_s * 1e3:.3f} ms against a "
          f"hit's {resp2[0].timing['compile_s'] * 1e3:.3f} ms; batch "
          f"{resp2[0].timing['run_s']:.3f}s; request latency p50 "
          f"{lat['p50_s']:.3f}s, p95 {lat['p95_s']:.3f}s over "
          f"{lat['count']}; {card}")

    # where the packed batch's wall goes: its set-up (the trials' lattice
    # draws and first counts), its MCS (the chunks) and the host copies
    # after each chunk, run apart on the cached entry's unit with a sync
    # after each part
    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    entry = next(iter(srv._cache._entries.values()))
    unit, pipe = entry.units[0], entry.pipe
    tkeys = torch.cat([trials.fold_trial_keys(threefry.PRNGKey(seed), n)
                       for seed, n, _ in SRV_REQS])
    (g, k), setup_s = timed(lambda: unit.init(tkeys))
    _, t = timed(lambda: unit.built.counts_batch(
        g, entry.params.species).cpu())
    setup_s += t
    mcs_s = copy_s = 0.0
    if pipe is not None:
        ring, pos = obs.ring_init(obs.ring_capacity(entry.params, SRV_CHUNK),
                                  (n_batch, pipe.width), dev)
    for _ in range(mcs_batch // SRV_CHUNK):
        if pipe is not None:
            out, t = timed(lambda: unit.chunk(g, k, ring, pos, SRV_CHUNK))
            g, k, ring, pos = out[:4]
        else:
            out, t = timed(lambda: unit.chunk(g, k, SRV_CHUNK))
            g, k = out[:2]
        mcs_s += t
        parts = [x for x in out[2:] if isinstance(x, torch.Tensor)]
        _, t = timed(lambda: [x.cpu() for x in parts])
        copy_s += t
    print(f"[serve] the batch's parts run apart ({n_batch} trials, "
          f"{mcs_batch} MCS in chunks of {SRV_CHUNK}, observables "
          f"{'on' if pipe is not None else 'off'}): set-up (draws and first "
          f"counts) {setup_s:.4f}s, MCS {mcs_s:.4f}s = "
          f"{mcs_s / mcs_batch * 1e3:.4f} ms per batch-MCS, host copies "
          f"{copy_s:.4f}s; sum {setup_s + mcs_s + copy_s:.4f}s against the "
          f"served batch's {run_s:.4f}s; {card}")

    # one sharded_pod request on a (2, 2, 2) mesh of cuda:0
    pod_srv = ScenarioServer(device=pod_devs)
    pod_eng = {"engine": "sharded_pod", "mesh_shape": list(POD_MESH),
               "local_kernel": "fused", "tile": list(TILE)}
    pod_req = sreq(4, SRV_POD_N, SRV_POD_MCS, "pod1", engine=pod_eng)
    ops.reset_launches()
    pod_resp = pod_srv(pod_req)
    launches["serve_pod"] = counted = ops.launches()
    check(pod_resp.ok, f"[serve] sharded_pod request failed: "
          f"{pod_resp.error}")
    pod_ref, _ = direct(pod_req, pod_devs)
    check(same_result(pod_resp.result, pod_ref),
          "[serve] the sharded_pod response differs from its direct "
          "run_trials")
    check(counted["escg_tile_round_fused_table"] == SRV_POD_MCS
          and counted["density_counts_sharded_trials"] == SRV_POD_MCS + 1,
          f"[serve] sharded_pod did not run one K1 table and one K4s "
          f"per-trial launch per MCS: {counted}")
    print(f"[serve] sharded_pod {POD_MESH} of cuda:0, {SRV_POD_N} trials x "
          f"{SRV_POD_MCS} MCS: equals its direct run_trials; launches "
          f"{counted}; batch {pod_resp.timing['run_s']:.3f}s")

    # the committed smoke trace through the serve entry point, on the card
    report_path = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_srv_"),
                               "report.json")
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--trace",
         os.path.join("examples", "traces", "smoke.jsonl"), "--waves", "2",
         "--check", "--report", report_path],
        capture_output=True, text=True, timeout=600, env=env, cwd=HERE)
    check(out.returncode == 0, f"[serve] the smoke trace's --check failed "
          f"(exit {out.returncode}):\n{out.stdout[-2000:]}\n"
          f"{out.stderr[-2000:]}")
    with open(report_path) as f:
        rep = json.load(f)
    shutil.rmtree(os.path.dirname(report_path), ignore_errors=True)
    check(rep["backend"] == "cuda"
          and rep["cache"]["misses"] == rep["cache"]["hits"]
          and rep["dropped"] == 0, f"[serve] smoke report: {rep['cache']}")
    print(f"[serve] examples/traces/smoke.jsonl --waves 2 --check on the "
          f"card: exit 0, {rep['n_requests']} requests, cache "
          f"{rep['cache']['hits']}H/{rep['cache']['misses']}M (the second "
          f"wave all hits), "
          f"{rep['requests_per_s']:.2f} req/s, latency p50 "
          f"{rep['latency']['total']['p50_s']:.4f}s; the process "
          f"{time.perf_counter() - t0:.2f}s")

    # one request through the HTTP adapter on 127.0.0.1
    httpd, _ = serve_http(srv, host="127.0.0.1", port=0, background=True)
    try:
        base = "http://127.0.0.1:%d" % httpd.server_address[1]
        http_req = sreq(5, 2, SRV_CHUNK, "http1")
        with urllib.request.urlopen(urllib.request.Request(
                base + "/submit", data=http_req.to_json().encode(),
                method="POST"), timeout=60) as f:
            check(json.loads(f.read()) == {"ids": ["http1"]},
                  "[serve] /submit")
        with urllib.request.urlopen(urllib.request.Request(
                base + "/drain", data=b"", method="POST"),
                timeout=600) as f:
            json.loads(f.read())
        with urllib.request.urlopen(base + "/response?id=http1",
                                    timeout=60) as f:
            wire = json.loads(f.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
    http_ref, _ = direct(http_req)
    check(wire["ok"] and wire["cache_hit"]
          and wire["result"] == json.loads(http_ref.to_json()),
          "[serve] the HTTP response differs from its direct run_trials")
    print("[serve] one request through the HTTP adapter on 127.0.0.1: a "
          "cache hit, equal to its direct run_trials")

    # ---- 28-31. the LM appendix and the checkpoint ----
    kept = lm_phases(torch, np, dev, card, park3, mesh4)

    # ---- 32-35. the LM appendix's moe, ssm, hybrid and encdec families ----
    lm_family_phases(torch, np, dev, card, park3, mesh4)

    # ---- 36-37. the LM appendix on a mesh and a pipeline ----
    lm_mesh_phases(torch, np, dev, card, kept)

    # ---- 38. the kernel table ----
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
        {"name": "escg_tile_round", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/escg_update.cu",
         "replaces": "src/repro/kernels/escg_update.py:90",
         "launches": launches["pallas"]["escg_tile_round"],
         "max_abs_err": k3_err, "ms": k3_ms, "plain_ms": k3_plain,
         "bound_ms": k3_bound, "bound_by": k3_by, "library_ms": None},
        {"name": "density_counts", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/density.cu",
         "replaces": "src/repro/kernels/density.py:41",
         "launches": launches["pallas"]["density_counts"],
         "max_abs_err": k4_err, "ms": k4_ms, "plain_ms": k4_plain,
         "bound_ms": k4_bound, "bound_by": k4_by, "library_ms": k4_lib},
        {"name": "density_counts_sharded", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/density.cu",
         "replaces": "src/repro/kernels/density.py:60",
         "launches": launches["sharded_fused"]["density_counts_sharded"],
         "max_abs_err": k4s_err, "ms": k4s_ms, "plain_ms": k4s_plain,
         "bound_ms": k4_bound, "bound_by": k4_by, "library_ms": k4s_lib},
        {"name": "philox_bits", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/philox.cu",
         "replaces": "src/repro/kernels/philox.py:101",
         "launches": launches["philox"]["philox_bits"],
         "max_abs_err": k5_err, "ms": k5_ms, "plain_ms": k5_plain,
         "bound_ms": k5_bound, "bound_by": k5_by, "library_ms": None},
        {"name": "reference_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/reference_scan.cu",
         "replaces": "src/repro/core/reference.py:24",
         "launches": launches["reference"]["reference_scan"],
         "max_abs_err": s1_err, "ms": s1_ms[REF_SIDE],
         "plain_ms": s1_plain[REF_SIDE],
         "bound_ms": s1_bound, "bound_by": s1_by, "library_ms": None},
        {"name": "escg_tile_round_fused_trials", "route": "cuda",
         "source": src,
         "replaces": "src/repro/kernels/escg_update_fused.py:130",
         "launches": launches[f"trials_fused_1_{TR_FUSED_N}"][
             "escg_tile_round_fused_trials"],
         "max_abs_err": tr_k1_err, "ms": k1t_ms, "plain_ms": k1t_plain,
         "bound_ms": TR_FUSED_N * k1_bound, "bound_by": k1_by,
         "library_ms": None},
        {"name": "escg_tile_rounds_fused_trials", "route": "cuda",
         "source": src,
         "replaces": "src/repro/kernels/escg_update_fused.py:252",
         "launches": launches[f"trials_fused_{K_MCS}_{TR_FUSED_N}"][
             "escg_tile_rounds_fused_trials"],
         "max_abs_err": tr_k2_err, "ms": k2t_ms, "plain_ms": k2t_plain,
         "bound_ms": TR_FUSED_N * k2_bound, "bound_by": k2_by,
         "library_ms": None},
        {"name": "escg_tile_round_trials", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/escg_update.cu",
         "replaces": "src/repro/kernels/escg_update.py:90",
         "launches": launches["trials_pallas"]["escg_tile_round_trials"],
         "max_abs_err": tr_k3_err, "ms": k3t_ms, "plain_ms": k3t_plain,
         "bound_ms": TR_PALLAS_N * k3_bound, "bound_by": k3_by,
         "library_ms": None},
        {"name": "density_counts_trials", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/density.cu",
         "replaces": "src/repro/kernels/density.py:41",
         "launches": launches[f"trials_fused_1_{TR_FUSED_N}"][
             "density_counts_trials"],
         "max_abs_err": tr_k4_err, "ms": k4t_ms, "plain_ms": k4t_plain,
         "bound_ms": TR_FUSED_N * k4_bound, "bound_by": k4_by,
         "library_ms": k4t_lib},
        {"name": "escg_tile_round_fused_table", "route": "cuda",
         "source": src,
         "replaces": "src/repro/kernels/escg_update_fused.py:130",
         "launches": launches["pod_fused"]["escg_tile_round_fused_table"],
         "max_abs_err": t1_err, "ms": k1_tab_ms, "plain_ms": k1_tab_plain,
         "bound_ms": k1_tab_bound, "bound_by": k1_tab_by,
         "library_ms": None},
        {"name": "escg_tile_round_table", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/escg_update.cu",
         "replaces": "src/repro/kernels/escg_update.py:90",
         "launches": launches["pod_pallas"]["escg_tile_round_table"],
         "max_abs_err": t3_err, "ms": k3_tab_ms, "plain_ms": k3_tab_plain,
         "bound_ms": k3_tab_bound, "bound_by": k3_tab_by,
         "library_ms": None},
        {"name": "density_counts_sharded_trials", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/density.cu",
         "replaces": "src/repro/kernels/density.py:60",
         "launches": launches["pod_fused"]["density_counts_sharded_trials"],
         "max_abs_err": t4_err, "ms": k4st_ms, "plain_ms": k4st_plain,
         "bound_ms": k4st_bound, "bound_by": k4st_by,
         "library_ms": k4st_lib},
    ]}))
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
