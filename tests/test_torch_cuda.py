"""The port's CUDA kernels and its main path on the card.

Every test here needs a CUDA card and skips without one. They import no
JAX, so they run on the GPU machine as they are:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The kernels are held to their plain PyTorch versions (which
``test_torch_kernels.py`` holds to the JAX package on the CPU), and
``simulate`` on the card to the fused and reference goldens, to itself
across ``k_mcs`` and observables, the ``pallas`` engine to
``sublattice``, ``batched`` to the CPU and to S1 dropping conflicts, and
the ``sharded`` engine on a mesh of one card's entries to its
single-device twins; the trial forms of K1-K4 to their plain versions,
and ``run_trials`` on the card to the CPU and, with no chunk's enqueue
waiting for the card, to itself without async statistics; the table
forms of K1 and K3 and K4s per trial (every block of every trial of a
card) to their plain versions, and ``sharded_pod`` on a (2, 2, 2) mesh of
one card's entries to the single-device trial engines; one LM train
step on the card to the CPU for each model family (dense, vlm, moe, ssm, hybrid, encdec), and a checkpoint round trip of card tensors (bfloat16, int32, a
``ShardedLattice`` restored onto other meshes of the card).
"""
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.core import (batched, dominance, lattice, rng, sharded,
                              threefry)
from repro_torch.core.scenarios import EngineConfig, RunConfig, make_scenario
from repro_torch.core.simulation import simulate
from repro_torch.kernels import density, escg_update, ops, philox
from repro_torch.kernels import reference_scan
from repro_torch.kernels import escg_update_fused as fused
from repro_torch.parallel.sharding import lattice_mesh

pytestmark = pytest.mark.cuda

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "fused_trajectory.json")
REF_GOLDEN = os.path.join(os.path.dirname(GOLDEN),
                          "reference_trajectory.json")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine with "
                    "-m cuda)")
    return torch.device("cuda")


def _tables(species, dev):
    dom = dominance.circulant(species, (1, 2) if species >= 5 else (1,))
    return (torch.as_tensor(dom).to(dev),
            torch.as_tensor(lattice.DIRS).to(dev))


def _grid(dev, species, dtype, seed=1):
    return lattice.init_grid(threefry.PRNGKey(seed), 64, 128, species, 0.1,
                             dtype=dtype, device=dev)


# (lattice, tile, proposals per tile, shift): the first is the original
# case; the others have 63 tiles (a partial group of the 32 a block
# stages), K other than th * tw, and shifts 1, H - 1 and W - 1
ROUND_CASES = [
    ((64, 128), (8, 16), 64, (0, 0)),
    ((72, 56), (8, 8), 64, (0, 0)),
    ((72, 112), (8, 16), 37, (1, 1)),
    ((72, 224), (8, 32), 256, (71, 223)),
    ((144, 224), (16, 32), 512, (0, 223)),
]


@pytest.mark.parametrize("hw,tile,k,shift", ROUND_CASES)
@pytest.mark.parametrize("dtype,nbhd", [(torch.int32, 4), (torch.int8, 8),
                                        (torch.int16, 4)])
@pytest.mark.parametrize("offset,gtw", [((0, 0), None), ((3, 7), 111),
                                        ((4, 4), 8)])
def test_round_kernel_equals_plain(cuda, dtype, nbhd, offset, gtw, hw, tile,
                                   k, shift):
    """K1 (with the roll fused into its tile load) against ``torch.roll``
    followed by the plain K1; ``tile_offset`` (4, 4) with ``grid_tiles_w``
    8 is block (1, 1) of a (2, 2) mesh, as the sharded engine calls it."""
    grid = lattice.init_grid(threefry.PRNGKey(1), *hw, 5, 0.1, dtype=dtype,
                             device=cuda)
    dom, dirs = _tables(5, cuda)
    before = fused.LAUNCHES["escg_tile_round_fused"]
    got = fused.escg_tile_round_fused(grid, (9, 10), 3, dom, dirs, tile, k,
                                      0.25, 0.6, nbhd, offset, gtw, shift)
    want = fused.escg_tile_round_fused_plain(
        torch.roll(grid, (-shift[0], -shift[1]), (0, 1)), (9, 10), 3, dom,
        tile, k, 0.25, 0.6, nbhd, offset, gtw)
    torch.cuda.synchronize()
    assert fused.LAUNCHES["escg_tile_round_fused"] == before + 1
    assert torch.equal(got, want)


# (lattice, tile, proposals per tile, steps, neighbourhood, species,
# tile_offset, grid_tiles_w): the first is the original case
MEGA_CASES = [
    ((64, 128), (8, 16), 64, 3, 4, 3, (0, 0), None),
    ((72, 56), (8, 8), 64, 1, 8, 5, (3, 7), 111),
    ((72, 112), (8, 16), 37, 10, 4, 3, (0, 0), None),
    ((72, 224), (8, 32), 256, 3, 8, 5, (0, 0), None),
    ((144, 224), (16, 32), 100, 10, 4, 3, (3, 7), 111),
]


def _schedule(n_steps, hw, dev):
    """Seeds with the extreme words, and shifts 0, 1, H - 1 and W - 1
    (the original three steps keep their shifts)."""
    h, w = hw
    shifts = ([(1, 5), (7, 0), (0, 15)] if n_steps == 3 else
              [(h - 1, w - 1), (0, 0), (1, 1), (h - 1, 0), (0, w - 1),
               (1, w - 1), (h - 1, 1), (0, 1), (1, 0), (7, 9)][:n_steps])
    words = [(1, 2), (2 ** 32 - 1, 5), (7, 8), (0, 2 ** 32 - 1)]
    seeds = [words[t % len(words)] for t in range(n_steps)]
    return (torch.tensor(seeds, dtype=torch.int64, device=dev),
            torch.tensor(shifts, dtype=torch.int64, device=dev))


@pytest.mark.parametrize("hw,tile,k,n_steps,nbhd,species,offset,gtw",
                         MEGA_CASES)
@pytest.mark.parametrize("dtype", [torch.int32, torch.int8, torch.int16])
def test_megakernel_equals_plain(cuda, dtype, hw, tile, k, n_steps, nbhd,
                                 species, offset, gtw):
    grid = lattice.init_grid(threefry.PRNGKey(2), *hw, species, 0.1,
                             dtype=dtype, device=cuda)
    dom, dirs = _tables(species, cuda)
    seeds, shifts = _schedule(n_steps, hw, cuda)
    got = fused.escg_tile_rounds_fused(grid, seeds, shifts, dom, dirs, tile,
                                       k, 0.25, 0.6, species, nbhd, offset,
                                       gtw)
    want = fused.escg_tile_rounds_fused_plain(grid, seeds, shifts, dom,
                                              tile, k, 0.25, 0.6, species,
                                              nbhd, offset, gtw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


def test_simulate_reproduces_golden_and_k_mcs(cuda):
    with open(GOLDEN) as f:
        want = json.load(f)

    def run(k_mcs):
        hashes = []
        res = simulate(make_scenario("nspecies5", mobility=1e-3, empty=0.1),
                       engine=EngineConfig(engine="pallas_fused",
                                           tile=(8, 8), k_mcs=k_mcs),
                       run=RunConfig(length=16, height=16, mcs=5,
                                     chunk_mcs=5 if k_mcs > 1 else 1,
                                     seed=11, observables=()),
                       stop_on_stasis=False,
                       hooks=[lambda m, g, c: hashes.append(
                           hashlib.sha256(g.cpu().numpy().astype("<i4")
                                          .tobytes()).hexdigest())])
        return hashes, res

    fused.reset_launches()
    hashes, res = run(1)
    assert hashes == want["grid_hashes"]
    assert fused.LAUNCHES["escg_tile_round_fused"] == 5
    _, res3 = run(3)
    assert fused.LAUNCHES["escg_tile_rounds_fused"] == 2
    np.testing.assert_array_equal(res3.grid, res.grid)
    np.testing.assert_array_equal(res3.densities,
                                  np.asarray(want["densities"]))


def test_tile_streams_on_the_card_equal_the_host(cuda):
    key = threefry.PRNGKey(7)
    ids = torch.arange(64)
    got = rng.tile_stream_batch(key.to(cuda), ids.to(cuda), 256, 180, 4)
    want = rng.tile_stream_batch(key, ids, 256, 180, 4)
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g.cpu(), w)


# (lattice, tile, proposals per tile, shift): the first is the original
# case; the others have partial groups of the 32 tiles a block stages, K
# other than th * tw (odd, so copied 4 bytes at a time) and below one
# chunk of the proposal stream, and shifts 1, H - 1 and W - 1
STREAM_CASES = [
    ((64, 128), (8, 16), 64, (0, 0)),
    ((72, 56), (8, 8), 64, (1, 1)),
    ((72, 56), (8, 8), 57, (71, 0)),
    ((72, 112), (8, 16), 128, (0, 111)),
    ((72, 112), (8, 16), 5, (1, 111)),
    ((72, 224), (8, 32), 256, (71, 223)),
    ((72, 224), (8, 32), 249, (3, 5)),
    ((144, 224), (16, 32), 512, (0, 0)),
    ((144, 224), (16, 32), 3, (143, 1)),
]


@pytest.mark.parametrize("hw,tile,k,shift", STREAM_CASES)
@pytest.mark.parametrize("dtype,nbhd", [(torch.int32, 4), (torch.int8, 8),
                                        (torch.int16, 4)])
def test_stream_round_kernel_equals_plain(cuda, dtype, nbhd, hw, tile, k,
                                          shift):
    """K3 (with the roll fused into its tile load) against ``torch.roll``
    followed by the plain K3."""
    grid = lattice.init_grid(threefry.PRNGKey(1), *hw, 5, 0.1, dtype=dtype,
                             device=cuda)
    dom, dirs = _tables(5, cuda)
    n_tiles = (hw[0] // tile[0]) * (hw[1] // tile[1])
    props = rng.tile_stream_batch(threefry.PRNGKey(3).to(cuda),
                                  torch.arange(n_tiles, device=cuda), k,
                                  (tile[0] - 2) * (tile[1] - 2), nbhd)
    before = escg_update.LAUNCHES["escg_tile_round"]
    got = escg_update.escg_tile_round(grid, *props, dom, dirs, tile, 0.25,
                                      0.6, shift)
    want = escg_update.escg_tile_round_plain(
        torch.roll(grid, (-shift[0], -shift[1]), (0, 1)), *props, dom, tile,
        0.25, 0.6)
    torch.cuda.synchronize()
    assert escg_update.LAUNCHES["escg_tile_round"] == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int8, torch.int16])
@pytest.mark.parametrize("species", [3, 5, 15, 16, 40])
@pytest.mark.parametrize("n", [0, 1, 31, 4099, 300 * 257])
def test_density_kernel_equals_plain(cuda, dtype, species, n):
    """K4 on both sides of its 16 register bins, over ragged lengths, with
    labels outside 0..S, and on a contiguous view that starts one cell in
    (not 16-byte aligned)."""
    x = torch.randint(-2, species + 4, (n + 1,), generator=torch.Generator()
                      .manual_seed(species + n)).to(dtype).to(cuda)
    for g in (x[:n], x[1:]):
        got = density.density_counts(g, species)
        want = density.density_counts_plain(g, species)
        torch.cuda.synchronize()
        assert got.dtype == torch.int32 and torch.equal(got, want)
        valid = g[(g >= 0) & (g <= species)].long()
        assert torch.equal(got.long(), torch.bincount(
            valid, minlength=species + 1))


@pytest.mark.parametrize("n", [0, 1, 4099, 1 << 20])
def test_philox_kernel_equals_plain(cuda, n):
    got = philox.philox_bits(n, (0xDEADBEEF, 7), 3, device=cuda)
    want = philox.philox_bits_plain(n, (0xDEADBEEF, 7), 3, device=cuda)
    torch.cuda.synchronize()
    assert got.dtype == torch.uint32 and got.shape == (n,)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    u = philox.philox_uniform(n, (0xDEADBEEF, 7), 3, device=cuda)
    assert torch.equal(u, philox.philox_uniform_plain(
        n, (0xDEADBEEF, 7), 3, device=cuda))
    assert n == 0 or (float(u.min()) >= 0.0 and float(u.max()) < 1.0)


def test_pallas_equals_sublattice_and_counts_through_k4(cuda):
    def run(engine, observables):
        return simulate(make_scenario("park3"),
                        engine=EngineConfig(engine=engine, tile=(8, 16)),
                        run=RunConfig(length=64, height=32, mcs=4,
                                      chunk_mcs=2, observables=observables),
                        stop_on_stasis=False)
    ops.reset_launches()
    res = run("pallas", None)
    counted = ops.launches()
    assert counted["escg_tile_round"] == 4
    assert counted["density_counts"] == 5      # the first lattice, 4 MCS
    plain = run("sublattice", None)
    np.testing.assert_array_equal(res.grid, plain.grid)
    for name in ("densities", "interface_length"):
        np.testing.assert_array_equal(res.observables[name],
                                      plain.observables[name])
    off = run("pallas", ())
    np.testing.assert_array_equal(off.grid, res.grid)
    np.testing.assert_array_equal(off.densities, res.densities)


@pytest.mark.parametrize("k_mcs", [1, 3])
def test_fused_observables_on_equal_off(cuda, k_mcs):
    def run(observables):
        return simulate(make_scenario("park3"),
                        engine=EngineConfig(engine="pallas_fused",
                                            tile=(8, 16), k_mcs=k_mcs),
                        run=RunConfig(length=64, height=32, mcs=7,
                                      chunk_mcs=4, observables=observables),
                        stop_on_stasis=False)
    on = run(("densities", "interface_length", "cluster_size", "snapshot"))
    off = run(())
    np.testing.assert_array_equal(on.grid, off.grid)
    np.testing.assert_array_equal(on.densities, off.densities)


@pytest.mark.parametrize("n_props", [4096, 4097])
@pytest.mark.parametrize("drop", [False, True])
@pytest.mark.parametrize("flux", [True, False])
@pytest.mark.parametrize("dtype,nbhd", [(torch.int32, 4), (torch.int8, 8),
                                        (torch.int16, 4), (torch.int32, 8),
                                        (torch.int8, 4), (torch.int16, 8)])
def test_reference_scan_equals_plain(cuda, dtype, nbhd, flux, drop,
                                     n_props):
    """S1 against its plain version (the host loop) at 64 x 64: lattice
    and applied count."""
    grid = lattice.init_grid(threefry.PRNGKey(7), 64, 64, 5, 0.1,
                             dtype=dtype, device=cuda)
    dom, dirs = _tables(5, cuda)
    props = rng.proposal_batch(threefry.PRNGKey(n_props + nbhd), n_props,
                               64 * 64, nbhd, device=cuda)
    before = reference_scan.LAUNCHES["reference_scan"]
    got_g, got_k = reference_scan.reference_scan(
        grid, *props, dom, dirs, 0.25, 0.6, flux, drop)
    want_g, want_k = reference_scan.reference_scan_plain(
        grid, *props, dom, 0.25, 0.6, flux, drop)
    torch.cuda.synchronize()
    assert reference_scan.LAUNCHES["reference_scan"] == before + 1
    assert got_g.is_cuda and got_g.dtype == dtype
    assert torch.equal(got_g, want_g)
    assert int(got_k) == int(want_k)
    assert (int(got_k) < n_props) == drop


def test_reference_scan_dropping_equals_batched_window(cuda):
    """One ``batched`` window on the card equals S1 with
    ``drop_conflicts``."""
    grid = lattice.init_grid(threefry.PRNGKey(2), 256, 256, 3, 0.1,
                             device=cuda)
    dom, dirs = _tables(3, cuda)
    props = rng.proposal_batch(threefry.PRNGKey(3), 256 * 256 // 8,
                               256 * 256, 4, device=cuda)
    g_bat, k_bat = batched.run_proposals(grid, props, 0.25, 0.6, dom, True)
    g_seq, k_seq = reference_scan.reference_scan(grid, *props, dom, dirs,
                                                 0.25, 0.6, True, True)
    assert torch.equal(g_bat, g_seq)
    assert int(k_bat) == int(k_seq) < 256 * 256 // 8


# S1's windows are 1,024 steps, 256 below 65,536 cells: streams shorter
# than one window, one step either side of a whole window, several windows
# and a ragged last one
SCAN_LENGTHS = (1, 255, 256, 257, 1023, 1024, 1025, 4097)


@pytest.mark.parametrize("n_props", SCAN_LENGTHS)
@pytest.mark.parametrize("side", [12, 64, 256])
def test_reference_scan_windows_equal_plain(cuda, side, n_props):
    """S1 against the host loop over whole and ragged windows, on a 12 x 12
    lattice (nearly every step shares a cell with an earlier one), 64 x 64
    and 256 x 256: every lattice type, both neighbourhoods, both boundaries
    (self-pairs at clamped edges) and ``drop_conflicts``; lattice and
    applied count."""
    dom, dirs = _tables(5, cuda)
    for dtype, nbhd in ((torch.int32, 4), (torch.int8, 8), (torch.int16, 4),
                        (torch.int32, 8), (torch.int8, 4), (torch.int16, 8)):
        grid = lattice.init_grid(threefry.PRNGKey(side), side, side, 5, 0.1,
                                 dtype=dtype, device=cuda)
        props = rng.proposal_batch(threefry.PRNGKey(n_props + nbhd),
                                   n_props, side * side, nbhd, device=cuda)
        for flux in (True, False):
            for drop in (False, True):
                got_g, got_k = reference_scan.reference_scan(
                    grid, *props, dom, dirs, 0.25, 0.6, flux, drop)
                want_g, want_k = reference_scan.reference_scan_plain(
                    grid, *props, dom, 0.25, 0.6, flux, drop)
                torch.cuda.synchronize()
                case = (dtype, nbhd, flux, drop)
                assert got_g.dtype == dtype, case
                assert torch.equal(got_g, want_g), case
                assert int(got_k) == int(want_k), case


def test_reference_scan_many_windows_equal_plain(cuda):
    """S1 over 65 windows at 256 x 256, without and with
    ``drop_conflicts``."""
    grid = lattice.init_grid(threefry.PRNGKey(4), 256, 256, 3, 0.1,
                             device=cuda)
    dom, dirs = _tables(3, cuda)
    props = rng.proposal_batch(threefry.PRNGKey(5), 256 * 256 + 7,
                               256 * 256, 4, device=cuda)
    for drop in (False, True):
        got_g, got_k = reference_scan.reference_scan(grid, *props, dom, dirs,
                                                     0.25, 0.6, True, drop)
        want_g, want_k = reference_scan.reference_scan_plain(
            grid, *props, dom, 0.25, 0.6, True, drop)
        torch.cuda.synchronize()
        assert torch.equal(got_g, want_g)
        assert int(got_k) == int(want_k)


def test_reference_golden_and_batched_on_the_card(cuda):
    """The reference golden through ``simulate`` on the card (S1 once per
    MCS), and ``batched`` on the card equal to the CPU."""
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
                   hooks=[lambda m, g, c: hashes.append(hashlib.sha256(
                       g.cpu().numpy().astype("<i4").tobytes()).hexdigest())])
    assert ops.launches()["reference_scan"] == cfg["mcs"]
    assert hashes == want["grid_hashes"]
    np.testing.assert_array_equal(res.densities, np.asarray(want["densities"]))
    assert res.kept_fraction == 1.0

    def run(device):
        return simulate(make_scenario("park3", boundary="reflect"),
                        run=RunConfig(length=96, height=64, mcs=3,
                                      chunk_mcs=2), device=device)
    on_card, on_host = run(None), run("cpu")
    np.testing.assert_array_equal(on_card.grid, on_host.grid)
    assert on_card.kept_fraction == on_host.kept_fraction < 1.0


# ------------------------ the sharded engine, one card --------------------- #

@pytest.mark.parametrize("species", [3, 40])
def test_density_counts_sharded_on_one_card_equals_plain(cuda, species):
    grid = torch.randint(-2, species + 4, (96, 160), device=cuda,
                         generator=torch.Generator(cuda).manual_seed(1),
                         dtype=torch.int32)
    lat = sharded.place(grid, lattice_mesh((2, 2), 96, 160, 8, 8,
                                           devices=["cuda:0"] * 4))
    before = dict(density.LAUNCHES)
    got = density.density_counts_sharded(lat.flat, species)
    torch.cuda.synchronize()
    assert density.LAUNCHES["density_counts_sharded"] == \
        before["density_counts_sharded"] + 1
    assert density.LAUNCHES["density_counts"] == before["density_counts"]
    assert torch.equal(got, density.density_counts_plain(grid, species))


@pytest.mark.parametrize("shard_grid", [(1, 1), (5, 8), (8, 9)])
@pytest.mark.parametrize("dtype", [torch.int8, torch.int16, torch.int32])
def test_density_counts_sharded_groups_equal_plain(cuda, dtype, shard_grid):
    """K4s on meshes of one card with one block, 40 blocks (a full table of
    ``MAX_GROUP`` and a part) and 72 (three launches), labels outside 0..S
    too, S on both sides of K4's 16 register bins: one launch per
    ``MAX_GROUP`` blocks, the plain count of the whole lattice."""
    rows, cols = shard_grid
    h, w = 16 * rows, 24 * cols
    n_blocks = rows * cols
    launches = -(-n_blocks // density.MAX_GROUP)
    for species in (3, 15, 16, 40):
        grid = torch.randint(-2, species + 4, (h, w), device=cuda,
                             generator=torch.Generator(cuda).manual_seed(
                                 species), dtype=torch.int32).to(dtype)
        lat = sharded.place(grid, lattice_mesh(
            shard_grid, h, w, 8, 8, devices=["cuda:0"] * n_blocks))
        before = dict(density.LAUNCHES)
        got = density.density_counts_sharded(lat.flat, species)
        torch.cuda.synchronize()
        assert density.LAUNCHES["density_counts_sharded"] == \
            before["density_counts_sharded"] + launches
        assert density.LAUNCHES["density_counts"] == before["density_counts"]
        assert got.dtype == torch.int32
        assert torch.equal(got, density.density_counts_plain(grid, species))


@pytest.mark.parametrize("local_kernel,single,kernel", [
    ("fused", "pallas_fused", "escg_tile_round_fused_table"),
    ("pallas", "pallas", "escg_tile_round_table")])
def test_sharded_on_one_card_equals_single_device(cuda, local_kernel, single,
                                                  kernel):
    """A (2, 2) mesh of four ``cuda:0`` entries: one table launch per MCS
    for the four blocks, one K4s launch for every count, no
    ``torch.roll``, and the single-device engine's lattice and streams."""
    def run(engine, device, **kw):
        return simulate(make_scenario("park3"),
                        engine=EngineConfig(engine=engine, tile=(8, 16),
                                            **kw),
                        run=RunConfig(length=128, height=64, mcs=4,
                                      chunk_mcs=2), stop_on_stasis=False,
                        device=device)
    real_roll, rolls = torch.roll, [0]

    def counted_roll(*args, **kwargs):
        rolls[0] += 1
        return real_roll(*args, **kwargs)
    ops.reset_launches()
    torch.roll = counted_roll
    try:
        got = run("sharded", ["cuda:0"] * 4, shard_grid=(2, 2),
                  local_kernel=local_kernel)
    finally:
        torch.roll = real_roll
    counted = ops.launches()
    assert counted[kernel] == 4 and counted["density_counts"] == 0
    assert counted["density_counts_sharded"] == 5
    assert rolls[0] == 0
    want = run(single, cuda)
    np.testing.assert_array_equal(got.grid, want.grid)
    for name in ("densities", "interface_length"):
        np.testing.assert_array_equal(got.observables[name],
                                      want.observables[name])


# ---------------------- the trial forms of K1-K4, one card ----------------- #

def _trial_grids(dev, n, hw, species, dtype, seed=3):
    return torch.stack([lattice.init_grid(threefry.PRNGKey(seed + t), *hw,
                                          species, 0.1, dtype=dtype,
                                          device=dev) for t in range(n)])


def _trial_shifts(n, hw, dev):
    """Per-trial shifts with 0, 1, H - 1 and W - 1 among them."""
    h, w = hw
    pattern = [(0, 0), (1, 1), (h - 1, w - 1), (h - 1, 0), (0, w - 1),
               (1, w - 1), (h - 1, 1), (5, 9)]
    return torch.tensor([pattern[t % len(pattern)] for t in range(n)],
                        dtype=torch.int64, device=dev)


def _trial_seeds(n, dev):
    words = [(1, 2), (2 ** 32 - 1, 5), (7, 8), (0, 2 ** 32 - 1)]
    return torch.tensor([words[t % 4] for t in range(n)], dtype=torch.int64,
                        device=dev)


@pytest.mark.parametrize("n", [1, 3, 16])
@pytest.mark.parametrize("hw,tile,k,shift", ROUND_CASES[1:])
@pytest.mark.parametrize("dtype,nbhd", [(torch.int32, 4), (torch.int8, 8),
                                        (torch.int16, 4)])
def test_round_trials_kernel_equals_plain(cuda, dtype, nbhd, hw, tile, k,
                                          shift, n):
    """K1 over a batch of trials, one launch, against the plain K1 of each
    trial with its own seed words and shift."""
    grids = _trial_grids(cuda, n, hw, 5, dtype)
    dom, dirs = _tables(5, cuda)
    seeds, shifts = _trial_seeds(n, cuda), _trial_shifts(n, hw, cuda)
    before = fused.LAUNCHES["escg_tile_round_fused_trials"]
    got = fused.escg_tile_round_fused_trials(grids, seeds, shifts, dom, dirs,
                                             tile, k, 0.25, 0.6, nbhd)
    want = fused.escg_tile_round_fused_trials_plain(
        grids, seeds, shifts, dom, tile, k, 0.25, 0.6, nbhd)
    torch.cuda.synchronize()
    assert fused.LAUNCHES["escg_tile_round_fused_trials"] == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("n", [1, 3, 16])
@pytest.mark.parametrize("hw,tile,k,n_steps,nbhd,species",
                         [c[:6] for c in MEGA_CASES[1:4]])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int8])
def test_megakernel_trials_equals_plain(cuda, dtype, hw, tile, k, n_steps,
                                        nbhd, species, n):
    """K2 over a batch of trials (the blocks walk (trial, group) pairs,
    each trial its own rolls and counts) against the plain K2 of each."""
    grids = _trial_grids(cuda, n, hw, species, dtype)
    dom, dirs = _tables(species, cuda)
    seeds = torch.stack([_schedule(n_steps, hw, cuda)[0].roll(t, 0)
                         for t in range(n)])
    shifts = torch.stack([_schedule(n_steps, hw, cuda)[1].roll(-t, 0)
                          for t in range(n)])
    got = fused.escg_tile_rounds_fused_trials(grids, seeds, shifts, dom,
                                              dirs, tile, k, 0.25, 0.6,
                                              species, nbhd)
    want = fused.escg_tile_rounds_fused_trials_plain(
        grids, seeds, shifts, dom, tile, k, 0.25, 0.6, species, nbhd)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("n", [1, 3, 16])
@pytest.mark.parametrize("hw,tile", [((72, 56), (8, 8)),
                                     ((72, 224), (8, 32)),
                                     ((144, 224), (16, 32))])
@pytest.mark.parametrize("dtype,nbhd", [(torch.int32, 4), (torch.int8, 8),
                                        (torch.int16, 8)])
def test_stream_round_trials_kernel_equals_plain(cuda, dtype, nbhd, hw,
                                                 tile, n):
    """K3 over a batch of trials against the plain K3 of each trial rolled
    by its shift, K = th * tw, th * tw - 7 and less than one chunk."""
    grids = _trial_grids(cuda, n, hw, 5, dtype)
    dom, dirs = _tables(5, cuda)
    shifts = _trial_shifts(n, hw, cuda)
    n_tiles = (hw[0] // tile[0]) * (hw[1] // tile[1])
    keys = threefry.split(threefry.PRNGKey(n), n).to(cuda)
    for k in (tile[0] * tile[1], tile[0] * tile[1] - 7,
              escg_update.CHUNK - 3):
        props = rng.tile_stream_batch(keys, torch.arange(n_tiles,
                                                         device=cuda), k,
                                      (tile[0] - 2) * (tile[1] - 2), nbhd)
        before = escg_update.LAUNCHES["escg_tile_round_trials"]
        got = escg_update.escg_tile_round_trials(grids, *props, dom, dirs,
                                                 tile, 0.25, 0.6, shifts)
        want = escg_update.escg_tile_round_trials_plain(
            grids, *props, dom, tile, 0.25, 0.6, shifts)
        torch.cuda.synchronize()
        assert escg_update.LAUNCHES["escg_tile_round_trials"] == \
            before + 1
        assert torch.equal(got, want)


@pytest.mark.parametrize("n", [1, 3, 40])
@pytest.mark.parametrize("hw", [(64, 64), (7, 9), (33, 31)])
@pytest.mark.parametrize("dtype", [torch.int8, torch.int16, torch.int32])
def test_density_trials_equals_plain(cuda, dtype, hw, n):
    """K4 per trial, one launch, on trials whose slices start anywhere
    (7 x 9 int8 lattices), labels outside 0..S, S on both sides of the 16
    register bins."""
    for species in (3, 15, 16, 40):
        grids = torch.randint(-2, species + 4, (n,) + hw, device=cuda,
                              generator=torch.Generator(cuda).manual_seed(
                                  species), dtype=torch.int32).to(dtype)
        before = density.LAUNCHES["density_counts_trials"]
        got = density.density_counts_trials(grids, species)
        torch.cuda.synchronize()
        assert density.LAUNCHES["density_counts_trials"] == before + 1
        assert got.shape == (n, species + 1) and got.dtype == torch.int32
        assert torch.equal(got, density.density_counts_trials_plain(
            grids, species))


@pytest.mark.parametrize("engine,k_mcs,kernel", [
    ("pallas_fused", 1, "escg_tile_round_fused_trials"),
    ("pallas_fused", 3, "escg_tile_rounds_fused_trials"),
    ("pallas", 1, "escg_tile_round_trials"),
    ("sublattice", 1, None), ("batched", 1, None), ("reference", 1, None)])
def test_run_trials_on_the_card_equals_the_cpu(cuda, engine, k_mcs, kernel):
    """``run_trials`` on the card equals the CPU's plain path, with one
    launch per kernel and MCS for all trials, and one K4 launch per
    count."""
    from repro_torch.core.trials import run_trials

    def run(device):
        return run_trials(make_scenario("nspecies5", mobility=1e-3,
                                        empty=0.1), n_trials=5,
                          engine=EngineConfig(engine=engine, tile=(8, 8),
                                              k_mcs=k_mcs),
                          run=RunConfig(length=32, height=24, mcs=7,
                                        chunk_mcs=4,
                                        observables=("densities",
                                                     "cluster_size")),
                          stop_on_stasis=False, device=device)
    ops.reset_launches()
    on_card = run(None)
    counted = ops.launches()
    on_host = run("cpu")
    assert on_card.to_json() == on_host.to_json()
    if kernel is not None:
        # 7 MCS in chunks of 4 and 3: with k_mcs 3, K2 runs groups of 3
        # and 1, then one of 3
        want = 3 if kernel == "escg_tile_rounds_fused_trials" else 7
        assert counted[kernel] == want
    if k_mcs == 1:
        assert counted["density_counts_trials"] == 7 + 1
    assert counted["density_counts"] == 0


@pytest.mark.parametrize("engine,k_mcs,dtype", [
    ("pallas_fused", 1, "int32"), ("pallas_fused", 1, "int8"),
    ("pallas_fused", 3, "int32"), ("pallas", 1, "int8"),
    ("batched", 1, "int32")])
def test_trial_chunk_on_the_card_equals_per_trial_simulate(cuda, engine,
                                                           k_mcs, dtype):
    """Each of 16 trials of ``build_trial_chunk`` on the card (one launch
    per kernel and MCS for the batch) equals ``simulate`` on the card from
    the trial's lattice and run key: final lattice, counts and kept
    count, over two chunks."""
    from repro_torch.core import engines, trials
    from repro_torch.core.scenarios import compose

    scenario = make_scenario("park3")
    p = compose(scenario, EngineConfig(engine=engine, tile=(8, 32),
                                       k_mcs=k_mcs, cell_dtype=dtype),
                RunConfig(length=256, height=128, mcs=6, chunk_mcs=3,
                          observables=()))
    dom = scenario.dominance()
    built = engines.build(p, dom, cuda)
    grids0, keys0 = trials.trial_grids_and_keys(
        p, threefry.PRNGKey(p.seed), 16, cuda)
    chunk = trials.build_trial_chunk(p, built)
    g, keys, kept_sum = grids0, keys0, 0
    for _ in range(2):
        g, keys, cnt, _, kept, _ = chunk(g, keys, 3)
        kept_sum = kept_sum + kept
    for t in range(16):
        s = simulate(p, dom, grid0=grids0[t], key=keys0[t],
                     stop_on_stasis=False, device=cuda)
        assert np.array_equal(s.grid, g[t].cpu().numpy()), t
        assert np.array_equal(s.densities[-1],
                              cnt[t].cpu().numpy() / p.n_cells), t
        assert s.kept_fraction == \
            int(kept_sum[t]) / (6 * built.attempts_per_mcs), t


@pytest.mark.parametrize("k_mcs", [1, 5])
def test_trial_chunk_enqueue_never_waits_for_the_card(cuda, k_mcs,
                                                      monkeypatch):
    """No chunk's enqueue (``_Pod.dispatch``: the key chain's copy, the
    updates, the rows and their ring push, the copies to the host)
    synchronises the host with the card, so the next chunk's key chain
    overlaps the card's work; the run equals ``async_stats=False`` bit for
    bit, observables included."""
    from repro_torch.core import trials

    def run(async_stats):
        return trials.run_trials(
            make_scenario("park3"), n_trials=4,
            engine=EngineConfig(engine="pallas_fused", tile=(8, 32),
                                k_mcs=k_mcs),
            run=RunConfig(length=256, height=256, mcs=15, chunk_mcs=5,
                          observables=("densities", "interface_length")),
            stop_on_stasis=False, async_stats=async_stats, device=cuda)

    want = run(False)       # also builds the kernels outside the watch
    dispatch, calls = trials._Pod.dispatch, []

    def watched(self, *args, **kwargs):
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = dispatch(self, *args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        calls.append(args)
        return out

    monkeypatch.setattr(trials._Pod, "dispatch", watched)
    got = run(True)
    assert len(calls) == 3
    assert got.mcs_completed == 15
    assert set(got.observables) == {"densities", "interface_length"}
    assert got.to_json() == want.to_json()


# ------- the table forms: every block of every trial of a card --------- #

# (block, tile, proposals per tile, halo rows, halo columns): every
# combination of halos, K other than th * tw, partial groups of tiles
TABLE_CASES = [
    ((24, 40), (8, 8), 64, True, True),
    ((16, 48), (8, 16), 37, True, False),
    ((24, 64), (8, 32), 256, False, True),
    ((32, 64), (16, 32), 512, False, False),
]
TABLE_SIZES = [(1, 1), (1, 16), (4, 3), (8, 1), (8, 16)]


def _table_runs(dev, n_runs, n, block, tile, halo, dtype, seed=11):
    """Sources (n, sh, sw) with labels -1..5, and each run's (n, 2) shifts:
    0, 1 and tile - 1 on an axis with a halo, and also H - 1 and W - 1
    without one."""
    (h, w), (th, tw) = block, tile
    sh, sw = h + (th if halo[0] else 0), w + (tw if halo[1] else 0)
    gen = torch.Generator(dev).manual_seed(seed)
    sources = [torch.randint(-1, 6, (n, sh, sw), device=dev, generator=gen,
                             dtype=torch.int32).clamp_(min=0).to(dtype)
               for _ in range(n_runs)]
    rows = [0, 1, th - 1] + ([] if halo[0] else [h - 1])
    cols = [0, 1, tw - 1] + ([] if halo[1] else [w - 1])
    shifts = [torch.tensor([(rows[(r + t) % len(rows)],
                             cols[(2 * r + t) % len(cols)])
                            for t in range(n)], dtype=torch.int64,
                           device=dev) for r in range(n_runs)]
    return sources, shifts


@pytest.mark.parametrize("n_runs,n", TABLE_SIZES)
@pytest.mark.parametrize("block,tile,k,halo_r,halo_c", TABLE_CASES)
@pytest.mark.parametrize("dtype,nbhd", [(torch.int32, 4), (torch.int8, 8),
                                        (torch.int16, 4)])
def test_round_table_kernel_equals_plain(cuda, dtype, nbhd, block, tile, k,
                                         halo_r, halo_c, n_runs, n):
    """K1's table form, one launch for every run and trial, against the
    plain K1 of each trial's window at its own shift, keyed by its run's
    tile offset in a global grid wider than the block."""
    sources, shifts = _table_runs(cuda, n_runs, n, block, tile,
                                  (halo_r, halo_c), dtype)
    seeds = [_trial_seeds(n, cuda).roll(r, 0) for r in range(n_runs)]
    offsets = [(3 * r, 2 * r + 1) for r in range(n_runs)]
    dom, dirs = _tables(5, cuda)
    gw = 3 * block[1] // tile[1] + 5
    before = fused.LAUNCHES["escg_tile_round_fused_table"]
    got = fused.escg_tile_round_fused_table(
        sources, seeds, shifts, offsets, block, dom, dirs, tile, k, 0.25,
        0.6, nbhd, gw)
    want = fused.escg_tile_round_fused_table_plain(
        sources, seeds, shifts, offsets, block, dom, tile, k, 0.25, 0.6,
        nbhd, gw)
    torch.cuda.synchronize()
    assert fused.LAUNCHES["escg_tile_round_fused_table"] == before + 1
    for a, b in zip(got, want):
        assert a.shape == (n,) + block and torch.equal(a, b)


@pytest.mark.parametrize("n_runs,n", TABLE_SIZES)
@pytest.mark.parametrize("block,tile,k,halo_r,halo_c", TABLE_CASES)
@pytest.mark.parametrize("dtype,nbhd", [(torch.int32, 4), (torch.int8, 8),
                                        (torch.int16, 4)])
def test_stream_round_table_kernel_equals_plain(cuda, dtype, nbhd, block,
                                                tile, k, halo_r, halo_c,
                                                n_runs, n):
    """K3's table form, one launch for every run and trial, against the
    plain K3 of each trial's window at its own shift with its own
    proposals."""
    sources, shifts = _table_runs(cuda, n_runs, n, block, tile,
                                  (halo_r, halo_c), dtype)
    (h, w), (th, tw) = block, tile
    n_tiles = (h // th) * (w // tw)
    props = [rng.tile_stream_batch(
        threefry.split(threefry.PRNGKey(20 + r), n).to(cuda),
        torch.arange(n_tiles, device=cuda) + 7 * r, k,
        (th - 2) * (tw - 2), nbhd) for r in range(n_runs)]
    dom, dirs = _tables(5, cuda)
    before = escg_update.LAUNCHES["escg_tile_round_table"]
    got = escg_update.escg_tile_round_table(sources, props, shifts, block,
                                            dom, dirs, tile, 0.25, 0.6)
    want = escg_update.escg_tile_round_table_plain(sources, props, shifts,
                                                   block, dom, tile, 0.25,
                                                   0.6)
    torch.cuda.synchronize()
    assert escg_update.LAUNCHES["escg_tile_round_table"] == before + 1
    for a, b in zip(got, want):
        assert a.shape == (n,) + block and torch.equal(a, b)


@pytest.mark.parametrize("groups,blocks", [(1, 1), (1, 4), (2, 4), (8, 1),
                                           (5, 8)])
@pytest.mark.parametrize("n", [1, 3, 16])
@pytest.mark.parametrize("dtype", [torch.int8, torch.int16, torch.int32])
def test_density_sharded_trials_equals_plain(cuda, dtype, n, groups,
                                             blocks):
    """K4s per trial: every block of every pod group in one launch per 32
    blocks (five groups of eight make two launches), a ticket per (group,
    trial), labels outside 0..S, S on both sides of the 16 register
    bins."""
    for species in (3, 16, 40):
        gen = torch.Generator(cuda).manual_seed(species)
        grp = [[torch.randint(-2, species + 4, (n, 12, 20), device=cuda,
                              generator=gen, dtype=torch.int32).to(dtype)
                for _ in range(blocks)] for _ in range(groups)]
        before = density.LAUNCHES["density_counts_sharded_trials"]
        got = density.density_counts_sharded_trials(grp, species)
        torch.cuda.synchronize()
        assert density.LAUNCHES["density_counts_sharded_trials"] == \
            before + -(-groups * blocks // density.MAX_GROUP)
        assert got.shape == (groups * n, species + 1)
        assert torch.equal(got, density.density_counts_sharded_trials_plain(
            grp, species))


@pytest.mark.parametrize("local_kernel,single,kernel", [
    ("fused", "pallas_fused", "escg_tile_round_fused_table"),
    ("pallas", "pallas", "escg_tile_round_table")])
@pytest.mark.parametrize("mesh_shape", [(2, 2, 2), (1, 2, 1), (4, 1, 2)])
def test_sharded_pod_on_one_card_equals_single_device(cuda, mesh_shape,
                                                      local_kernel, single,
                                                      kernel):
    """``run_trials`` of ``sharded_pod`` over a mesh of ``cuda:0`` entries:
    one table launch and one K4s-per-trial launch per MCS for every trial
    of every pod group, no ``torch.roll``, and the single-device engine's
    trials, observables included."""
    from repro_torch.core.trials import run_trials

    def run(engine, device, **kw):
        return run_trials(make_scenario("park3"), n_trials=7,
                          engine=EngineConfig(engine=engine, tile=(8, 16),
                                              **kw),
                          run=RunConfig(length=128, height=64, mcs=4,
                                        chunk_mcs=2),
                          stop_on_stasis=False, device=device)
    real_roll, rolls = torch.roll, [0]

    def counted_roll(*args, **kwargs):
        rolls[0] += 1
        return real_roll(*args, **kwargs)
    n_dev = mesh_shape[0] * mesh_shape[1] * mesh_shape[2]
    ops.reset_launches()
    torch.roll = counted_roll
    try:
        got = run("sharded_pod", ["cuda:0"] * n_dev, mesh_shape=mesh_shape,
                  local_kernel=local_kernel)
    finally:
        torch.roll = real_roll
    counted = ops.launches()
    assert counted[kernel] == 4
    assert counted["density_counts_sharded_trials"] == 4 + 1
    assert counted["density_counts"] == counted["density_counts_trials"] == 0
    assert rolls[0] == 0
    want = run(single, cuda)
    got_d, want_d = json.loads(got.to_json()), json.loads(want.to_json())
    assert got_d.pop("n_devices") == n_dev and want_d.pop("n_devices") == 1
    assert got_d == want_d


@pytest.mark.parametrize("mesh_shape", [(4, 1, 1), (2, 2, 1)])
def test_sharded_pod_k_mcs_on_one_card_equals_pallas_fused(cuda,
                                                           mesh_shape):
    """``k_mcs=3`` on ``sharded_pod``/'fused': K2's trial form once per pod
    group and launch group on a (P, 1, 1) mesh, K single table rounds
    elsewhere; either way the trials of ``pallas_fused``."""
    from repro_torch.core.trials import run_trials

    def run(engine, device, **kw):
        return run_trials(make_scenario("park3"), n_trials=8,
                          engine=EngineConfig(engine=engine, tile=(8, 16),
                                              k_mcs=3, **kw),
                          run=RunConfig(length=128, height=64, mcs=7,
                                        chunk_mcs=7, observables=()),
                          stop_on_stasis=False, device=device)
    n_dev = mesh_shape[0] * mesh_shape[1]
    ops.reset_launches()
    got = run("sharded_pod", ["cuda:0"] * n_dev, mesh_shape=mesh_shape,
              local_kernel="fused")
    counted = ops.launches()
    if mesh_shape[1] == 1:
        assert counted["escg_tile_rounds_fused_trials"] == 3 * mesh_shape[0]
    else:
        assert counted["escg_tile_round_fused_table"] == 7
    want = run("pallas_fused", cuda)
    np.testing.assert_array_equal(got.densities, want.densities)
    np.testing.assert_array_equal(got.extinction_mcs, want.extinction_mcs)


# --------------------- the LM appendix on the card ----------------------- #

@pytest.mark.parametrize("arch,optimizer", [
    ("granite-3-8b", "adamw"), ("pixtral-12b", "adafactor"),
    ("grok-1-314b", "adamw"), ("kimi-k2-1t-a32b", "adafactor"),
    ("falcon-mamba-7b", "adamw"), ("zamba2-7b", "adamw"),
    ("whisper-small", "adamw")])
def test_lm_train_step_on_the_card_equals_the_cpu(cuda, arch, optimizer):
    """One train step of a reduced model (float32) on the card against the
    same step on the CPU: the loss within 1e-5 relative, every optimizer
    leaf within 1e-4, the params within 1e-4, except where AdamW's first
    update g / (|g| + 1e-8) is ill-conditioned (|g| under 1e-6, read off
    the first moment (1 - b1) g): there within its range, 2 lr."""
    from repro_torch.configs import ARCHS, ShapeConfig
    from repro_torch.convert import state_to_numpy
    from repro_torch.data import batch_for_model
    from repro_torch.models import build_model
    from repro_torch.models.spec import tree_leaves
    from repro_torch.runtime import train_lib

    model = build_model(ARCHS[arch].reduced().replace(optimizer=optimizer))
    out = {}
    for dev in ("cpu", cuda):
        st = train_lib.init_state(model, threefry.PRNGKey(0), device=dev)
        batch = batch_for_model(model, ShapeConfig("t", 64, 2, "train"), 0,
                                device=dev)
        out[str(dev)] = train_lib.make_train_step(model)(st, batch)
    (cs, cm), (gs, gm) = out["cpu"], out[str(cuda)]
    assert int(gs["step"]) == 1 and gs["step"].device.type == "cuda"
    np.testing.assert_allclose(float(gm["loss"]), float(cm["loss"]),
                               rtol=1e-5)
    for a, b in zip(tree_leaves(state_to_numpy(cs["opt"])),
                    tree_leaves(state_to_numpy(gs["opt"]))):
        np.testing.assert_allclose(b, a, rtol=1e-4,
                                   atol=1e-4 * np.abs(a).max() + 1e-12)
    moments = tree_leaves(state_to_numpy(cs["opt"]))[0::2]
    for i, (a, b) in enumerate(zip(tree_leaves(state_to_numpy(cs["params"])),
                                   tree_leaves(state_to_numpy(gs["params"])))):
        ill = (np.abs(moments[i]) / 0.1 < 1e-6 if optimizer == "adamw"
               else np.zeros(a.shape, bool))
        tol = np.where(ill, 6e-4, 1e-4 + 1e-4 * np.abs(a))
        assert (np.abs(b - a) <= tol).all(), (arch, i)


def test_checkpoint_round_trip_of_card_tensors(cuda, tmp_path):
    """bfloat16, int32 and a ``ShardedLattice`` on a (2, 2) mesh of
    ``cuda:0`` saved from the card and restored onto it: onto the card
    whole, and onto (4, 1) and (2, 2) meshes of ``cuda:0``, bit for
    bit."""
    from repro_torch.parallel.sharding import LatticeMesh
    from repro_torch.runtime.checkpoint import CheckpointManager

    words = torch.randint(-2 ** 15, 2 ** 15, (33, 70), dtype=torch.int32,
                          generator=torch.Generator().manual_seed(0))
    half = words.to(torch.int16).view(torch.bfloat16).to(cuda)
    ints = words.to(cuda)
    grid = lattice.init_grid(threefry.PRNGKey(2), 256, 512, 3, 0.1,
                             dtype=torch.int8, device=cuda)
    mesh22 = LatticeMesh(((torch.device(cuda.type, 0),) * 2,) * 2)
    mesh41 = LatticeMesh(((torch.device(cuda.type, 0),),) * 4)
    cm = CheckpointManager(str(tmp_path), device=cuda)
    cm.save(1, {"h": half, "i": ints, "g": sharded.place(grid, mesh22)},
            blocking=False)
    half.fill_(0)                       # the save holds its own host copy
    cm.wait()
    _, whole = cm.restore()
    assert whole["h"].device.type == "cuda" and whole["h"].dtype == \
        torch.bfloat16
    assert torch.equal(whole["h"].view(torch.int16).cpu(),
                       words.to(torch.int16))
    assert torch.equal(whole["i"], ints) and torch.equal(whole["g"], grid)
    for mesh in (mesh41, mesh22):
        _, got = cm.restore(shardings={"g": mesh})
        assert got["g"].mesh.shape == mesh.shape
        assert all(b.device.type == "cuda" for b in got["g"].flat)
        assert torch.equal(got["g"].gather(), grid)
