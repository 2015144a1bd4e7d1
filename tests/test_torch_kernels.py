"""The port's kernel modules against the reference's plain oracles.

On the CPU every wrapper takes its plain PyTorch version, which is held
here to the JAX package's oracles (``kernels/ref.py``, ``core/rules.py``,
``core/sublattice.py``) bit for bit, and for K4 and K5 to the Pallas
kernels themselves in interpret mode, which run on the installed JAX.
``test_torch_cuda.py`` holds the CUDA kernels to those plain versions on
the card.
"""
import ctypes
import re
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lattice as jlattice
from repro.core import metrics as jmetrics
from repro.core import rng as jrng
from repro.core import rules as jrules
from repro.core import sublattice as jsublattice
from repro.kernels import ops as jops
from repro.kernels import ref
from repro_torch.core import dominance, lattice, rng, rules, threefry
from repro_torch.kernels import build, density, escg_update
from repro_torch.kernels import escg_update_fused as fused
from repro_torch.kernels import ops, philox, reference_scan

KNOWN_ANSWER = {
    # Random123 published KATs for philox4x32-10
    ((0, 0, 0, 0), (0, 0)): (0x6627E8D5, 0xE169C58D, 0xBC57AC4C,
                             0x9B00DBD8),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2): (0x408F276D, 0x41C83B0E,
                                             0xA20BC7C6, 0x6D5451FD),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0)): (0xD16CFE09, 0x94FDCCEB, 0x5001E420,
                                 0x24126EA1),
}


def _dom(species):
    return dominance.circulant(species, (1, 2) if species >= 5 else (1,))


# ------------------------------- philox ---------------------------------- #

@pytest.mark.parametrize("case", sorted(KNOWN_ANSWER))
def test_philox_known_answer(case):
    ctr, key = case
    words = philox.philox_rounds(*(torch.tensor([c]) for c in ctr), *key)
    assert tuple(int(w[0]) for w in words) == KNOWN_ANSWER[case]


@pytest.mark.parametrize("key", [(0, 0), (0xDEADBEEF, 0x12345678)])
def test_philox_matches_host_oracle(key):
    rng = np.random.RandomState(3)
    ctr = rng.randint(0, 2 ** 32, size=(4, 257), dtype=np.uint64)
    want = ref.philox4x32_ref(*ctr.astype(np.uint32), *key)
    got = philox.philox_rounds(*(torch.from_numpy(c.astype(np.int64))
                                 for c in ctr), *key)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.astype(np.int64))


@pytest.mark.parametrize("interior,nbhd", [(84, 4), (180, 8), (1, 4)])
def test_proposal_fields_match_oracle(interior, nbhd):
    seed, rnd = (0xABCD1234, 0x5678DEAD), 7
    want = ref.fused_proposals_ref(6, 41, interior, nbhd, seed, rnd)
    got = philox.philox_proposal_fields(torch.arange(6 * 41), rnd, *seed,
                                        interior, nbhd)
    for g, w in zip(got, want):
        assert g.dtype == torch.from_numpy(w).dtype
        np.testing.assert_array_equal(g.reshape(6, 41).numpy(), w)


# ------------------------------ pair rule -------------------------------- #

@pytest.mark.parametrize("dtype", ["int8", "int32"])
@pytest.mark.parametrize("species", [3, 5])
def test_apply_pair_all_pairs_and_threshold_edges(dtype, species):
    """Every (s, n) pair against draws on and beside the float32-rounded
    thresholds and the dominance rates."""
    t_eps, t_eps_mu = 0.1, 0.7              # not exact in float32
    dom = _dom(species)
    dom[1:, 1:] *= 0.6                      # rates below 1: p1 + p2 edges
    edges = [np.float32(t_eps), np.float32(t_eps_mu), np.float32(0.6),
             np.float32(1.2), 0.0]
    u = sorted({float(np.nextafter(np.float32(e), np.float32(d)))
                for e in edges for d in (-1, 2)} | {float(np.float32(e))
                                                   for e in edges})
    u = np.asarray([x for x in u if 0.0 <= x < 1.0], np.float32)
    s, n, ua, ud = np.meshgrid(np.arange(species + 1), np.arange(species + 1),
                               u, u, indexing="ij")
    s, n = s.astype(dtype).ravel(), n.astype(dtype).ravel()
    ua, ud = ua.ravel(), ud.ravel()
    want = jrules.apply_pair(jnp.asarray(s), jnp.asarray(n), jnp.asarray(ua),
                             jnp.asarray(ud), t_eps, t_eps_mu,
                             jnp.asarray(dom))
    got = rules.apply_pair(torch.from_numpy(s), torch.from_numpy(n),
                           torch.from_numpy(ua), torch.from_numpy(ud),
                           t_eps, t_eps_mu, torch.from_numpy(dom))
    for g, w in zip(got, want):
        assert str(g.dtype) == f"torch.{dtype}"
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ------------------------- K1: plain version ----------------------------- #

def _grid(h, w, species, dtype="int32", seed=1):
    g = lattice.init_grid(threefry.PRNGKey(seed), h, w, species, 0.1,
                          dtype=getattr(torch, dtype), device="cpu")
    return g


def _oracle_round(grid, seed, rnd, dom, tile, k, te, tem, nbhd,
                  tile_offset=(0, 0), grid_tiles_w=None):
    """Host Philox for the given global tile ids feeding the reference's
    tile oracle."""
    h, w = grid.shape
    th, tw = tile
    gh, gw = h // th, w // tw
    gtw = gw if grid_tiles_w is None else grid_tiles_w
    ti, tj = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
    tile_id = ((tile_offset[0] + ti) * gtw + tile_offset[1] + tj).ravel()
    idx = (tile_id[:, None] * k + np.arange(k)[None, :]).astype(np.uint32)
    x = ref.philox4x32_ref(idx.ravel(), np.full(idx.size, rnd, np.uint32),
                           np.zeros(idx.size, np.uint32),
                           np.zeros(idx.size, np.uint32), *seed)
    interior = (th - 2) * (tw - 2)
    cell = (x[0] % np.uint32(interior)).astype(np.int32).reshape(-1, k)
    dirn = (x[1] % np.uint32(nbhd)).astype(np.int32).reshape(-1, k)
    ua = ((x[2] >> 8).astype(np.float32) * 2.0 ** -24).reshape(-1, k)
    ud = ((x[3] >> 8).astype(np.float32) * 2.0 ** -24).reshape(-1, k)
    return np.asarray(ref.escg_tile_round_ref(
        jnp.asarray(grid.numpy()), jnp.asarray(cell), jnp.asarray(dirn),
        jnp.asarray(ua), jnp.asarray(ud), jnp.asarray(dom), tile, te, tem))


@pytest.mark.parametrize("hw,tile,species,nbhd,dtype", [
    ((32, 64), (8, 16), 5, 4, "int32"),
    ((16, 16), (8, 8), 3, 8, "int8"),
    ((24, 48), (8, 16), 8, 4, "int16"),
])
def test_plain_round_matches_oracle(hw, tile, species, nbhd, dtype):
    """The plain K1 equals ``ref.fused_proposals_ref`` fed into
    ``ref.escg_tile_round_ref``."""
    grid = _grid(*hw, species, dtype)
    dom = _dom(species)
    nt = (hw[0] // tile[0]) * (hw[1] // tile[1])
    seed, k = (0xABCD1234, 0x5678DEAD), 61
    got = fused.escg_tile_round_fused_plain(
        grid, seed, 7, torch.from_numpy(dom), tile, k, 0.25, 0.6, nbhd)
    cell, dirn, ua, ud = ref.fused_proposals_ref(
        nt, k, (tile[0] - 2) * (tile[1] - 2), nbhd, seed, 7)
    want = ref.escg_tile_round_ref(
        jnp.asarray(grid.numpy()), jnp.asarray(cell), jnp.asarray(dirn),
        jnp.asarray(ua), jnp.asarray(ud), jnp.asarray(dom), tile, 0.25, 0.6)
    assert got.dtype == grid.dtype
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not torch.equal(got, grid)


@pytest.mark.parametrize("nbhd", [4, 8])
def test_plain_round_tile_offset_matches_oracle(nbhd):
    """A shard keys its counters by global tile id."""
    grid = _grid(16, 32, 3)
    dom = _dom(3)
    got = fused.escg_tile_round_fused_plain(
        grid, (5, 6), 2, torch.from_numpy(dom), (8, 16), 40, 0.3, 0.65,
        nbhd, tile_offset=(3, 7), grid_tiles_w=111)
    want = _oracle_round(grid, (5, 6), 2, dom, (8, 16), 40, 0.3, 0.65, nbhd,
                         (3, 7), 111)
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrapper_on_cpu_is_the_plain_version_and_counts_no_launch():
    grid = _grid(16, 32, 3)
    dom = torch.from_numpy(_dom(3))
    dirs = torch.as_tensor(lattice.DIRS)
    fused.reset_launches()
    got = ops.escg_round_fused(grid, (1, 2), 0, (3, 5), dom, dirs, (8, 16),
                               30, 0.25, 0.6, roll_back=False)
    want = fused.escg_tile_round_fused_plain(
        torch.roll(grid, (-3, -5), (0, 1)), (1, 2), 0, dom, (8, 16), 30,
        0.25, 0.6)
    assert torch.equal(got, want)
    back = ops.escg_round_fused(grid, (1, 2), 0, (3, 5), dom, dirs, (8, 16),
                                30, 0.25, 0.6)
    assert torch.equal(back, torch.roll(want, (3, 5), (0, 1)))
    assert {"escg_tile_round_fused", "escg_tile_rounds_fused"} <= \
        set(fused.LAUNCHES)
    assert set(fused.LAUNCHES.values()) == {0}


def test_wrapper_rejects_bad_input():
    grid = _grid(16, 32, 3)
    dom = torch.from_numpy(_dom(3))
    dirs = torch.as_tensor(lattice.DIRS)
    args = ((1, 2), 0, dom, dirs)
    with pytest.raises(ValueError, match="divide"):
        fused.escg_tile_round_fused(grid, *args, (8, 12), 8, 0.2, 0.5)
    with pytest.raises(ValueError, match="dtype"):
        fused.escg_tile_round_fused(grid.long(), *args, (8, 16), 8, 0.2,
                                    0.5)
    with pytest.raises(ValueError, match="dirs"):
        fused.escg_tile_round_fused(grid, (1, 2), 0, dom, dirs.long(),
                                    (8, 16), 8, 0.2, 0.5)
    with pytest.raises(ValueError, match="CUDA"):
        fused.escg_tile_round_fused(grid.to("meta"), (1, 2), 0,
                                    dom.to("meta"), dirs.to("meta"),
                                    (8, 16), 8, 0.2, 0.5)


@pytest.mark.parametrize("dy,dx", [(0, 0), (1, 1), (15, 31), (1, 31)])
def test_round_with_shift_matches_rolled_oracle(dy, dx):
    """``ops.escg_round_fused`` without the roll back, and K1 given the
    shift (which its kernel fuses into the tile load), equal the grid
    rolled by ``-shift`` fed to the reference's oracle of K1."""
    grid = _grid(16, 32, 5, seed=6)
    dom = _dom(5)
    tile, k, seed = (8, 16), 53, (0x1234ABCD, 0x9E3779B9)
    rolled = jnp.roll(jnp.asarray(grid.numpy()), (-dy, -dx), (0, 1))
    cell, dirn, ua, ud = ref.fused_proposals_ref(4, k, 6 * 14, 8, seed, 3)
    want = np.asarray(ref.escg_tile_round_ref(
        rolled, jnp.asarray(cell), jnp.asarray(dirn), jnp.asarray(ua),
        jnp.asarray(ud), jnp.asarray(dom), tile, 0.25, 0.6))
    dirs = torch.as_tensor(lattice.DIRS)
    got = ops.escg_round_fused(grid, seed, 3, (dy, dx), torch.from_numpy(dom),
                               dirs, tile, k, 0.25, 0.6, 8, roll_back=False)
    np.testing.assert_array_equal(got.numpy(), want)
    direct = fused.escg_tile_round_fused(grid, seed, 3, torch.from_numpy(dom),
                                         dirs, tile, k, 0.25, 0.6, 8,
                                         shift=(dy, dx))
    assert torch.equal(direct, got)


@pytest.mark.parametrize("tile,cell_bytes,n_dom,want", [
    ((8, 32), 4, 4, (1, 32)),          # park3's main path: int8 staging
    ((8, 8), 1, 6, (1, 32)),
    ((16, 32), 2, 4, (1, 32)),
    ((5, 7), 4, 4, (1, 32)),           # rows padded to 8 cells
    ((64, 64), 4, 200, (4, 14)),       # labels past int8: int32 staging
])
def test_staging_sizes(tile, cell_bytes, n_dom, want):
    stage, per_block = fused.staging(tile, cell_bytes, n_dom)
    assert (stage, per_block) == want
    row_bytes = 4 * -(-tile[1] * stage // 4)
    assert per_block * tile[0] * row_bytes + 4 * n_dom <= fused.SMEM_BYTES


@pytest.mark.parametrize("kernel", ["K1", "K2", "K3"])
def test_oversize_tile_raises_before_launch(kernel):
    """A tile the staging cannot hold raises ``ValueError`` in the wrapper
    before the card is touched (a meta tensor reaches no launch)."""
    with pytest.raises(ValueError, match="shared memory"):
        fused.staging((256, 256), 4, 200)
    with pytest.raises(ValueError, match="shared memory"):
        escg_update.staging((256, 256), 4, 200)
    grid = torch.zeros((1024, 1024), dtype=torch.int8, device="meta")
    dom = torch.zeros((4, 4), dtype=torch.float32, device="meta")
    dirs = torch.zeros((8, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="shared memory"):
        if kernel == "K1":
            fused.escg_tile_round_fused(grid, (1, 2), 0, dom, dirs,
                                        (512, 512), 8, 0.2, 0.5)
        elif kernel == "K2":
            sched = torch.zeros((2, 2), dtype=torch.int64, device="meta")
            fused.escg_tile_rounds_fused(grid, sched, sched, dom, dirs,
                                         (512, 512), 8, 0.2, 0.5, 3)
        else:
            props = [torch.zeros((4, 8), dtype=dt, device="meta")
                     for dt in (torch.int32, torch.int32, torch.float32,
                                torch.float32)]
            escg_update.escg_tile_round(grid, *props, dom, dirs, (512, 512),
                                        0.2, 0.5)


class _RecordingLib:
    """Stands in for a loaded library: records the ctypes signatures a
    module's ``_lib`` sets."""

    def __init__(self):
        self.fns = {}

    def __getattr__(self, name):
        return self.fns.setdefault(
            name, types.SimpleNamespace(argtypes=None, restype=None))


_C_TYPES = {"int": ctypes.c_int, "uint32_t": ctypes.c_uint32,
            "int64_t": ctypes.c_int64, "float": ctypes.c_float}


def _c_declarations(path):
    """name -> (return type, parameter types) of the ``extern "C"``
    functions of a source; pointers as ``c_void_p``."""
    block = path.read_text().split('extern "C" {', 1)[1]
    decls = {}
    for ret, name, params in re.findall(
            r"^(int|const char\*)\s+(\w+)\(([^)]*)\)\s*\{", block, re.M):
        kinds = []
        for param in params.split(","):
            ctype = param.rsplit(None, 1)[0].replace("const ", "").strip()
            kinds.append(ctypes.c_void_p if "*" in param
                         else _C_TYPES[ctype])
        decls[name] = (ret, kinds)
    return decls


@pytest.mark.parametrize("module", [fused, escg_update, density, philox,
                                    reference_scan],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_ctypes_signatures_match_c_declarations(module, monkeypatch):
    """Every entry point of ``csrc/<library>.cu`` is bound with as many
    arguments as it declares, each of the same kind (pointer, 32-bit
    signed or unsigned, 64-bit, float); a mismatch would otherwise show
    only on the card."""
    lib = _RecordingLib()
    monkeypatch.setattr(build, "load", lambda name: lib)
    module._lib()
    decls = _c_declarations(Path(build.CSRC) / f"{module._LIB}.cu")
    # escg_error_string is bound by build.load for every library
    assert decls.pop("escg_error_string")[1] == [ctypes.c_int]
    assert set(decls) == set(lib.fns)
    for name, (ret, kinds) in decls.items():
        fn = lib.fns[name]
        assert ret == "int" and fn.restype is ctypes.c_int, name
        assert list(fn.argtypes) == kinds, name


def test_counter_capacity_guard():
    fused.check_counter_capacity(1 << 16, 1 << 16)          # exactly 2^32
    with pytest.raises(ValueError, match="counter"):
        fused.check_counter_capacity((1 << 16) + 1, 1 << 16)
    grid = torch.zeros((3 * 8, 3 * 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="counter"):
        fused.escg_tile_round_fused_plain(
            grid, (0, 0), 0, torch.from_numpy(_dom(3)), (8, 8), 2 ** 29,
            0.2, 0.5)


# ------------------------- K2: plain version ----------------------------- #

@pytest.mark.parametrize("hw,tile,species,nbhd,dtype", [
    ((16, 32), (8, 16), 5, 4, "int32"),
    ((16, 16), (8, 8), 3, 8, "int8"),
])
def test_plain_megakernel_matches_oracle_rounds(hw, tile, species, nbhd,
                                                dtype):
    """K steps of the plain K2 equal K reference oracle rounds in the
    drifting frame, with the per-step counts of ``metrics.counts``."""
    grid = _grid(*hw, species, dtype, seed=4)
    dom = _dom(species)
    k, k_steps = 37, 4
    rng = np.random.RandomState(7)
    seeds = rng.randint(0, 2 ** 32, size=(k_steps, 2), dtype=np.uint64)
    shifts = np.stack([rng.randint(0, tile[0], k_steps),
                       rng.randint(0, tile[1], k_steps)], axis=1)
    got_g, got_c = fused.escg_tile_rounds_fused(
        grid, torch.from_numpy(seeds.astype(np.int64)),
        torch.from_numpy(shifts.astype(np.int64)), torch.from_numpy(dom),
        torch.as_tensor(lattice.DIRS), tile, k, 0.25, 0.6, species, nbhd)
    assert got_c.shape == (k_steps, species + 1)
    assert got_c.dtype == torch.int32
    nt = (hw[0] // tile[0]) * (hw[1] // tile[1])
    g = jnp.asarray(grid.numpy())
    for t in range(k_steps):
        g = jnp.roll(g, (-int(shifts[t, 0]), -int(shifts[t, 1])), (0, 1))
        cell, dirn, ua, ud = ref.fused_proposals_ref(
            nt, k, (tile[0] - 2) * (tile[1] - 2), nbhd, seeds[t], 0)
        g = ref.escg_tile_round_ref(g, jnp.asarray(cell), jnp.asarray(dirn),
                                    jnp.asarray(ua), jnp.asarray(ud),
                                    jnp.asarray(dom), tile, 0.25, 0.6)
        np.testing.assert_array_equal(
            got_c[t].numpy(), np.asarray(jmetrics.counts(g, species)),
            err_msg=f"step {t} counts")
    np.testing.assert_array_equal(got_g.numpy(), np.asarray(g))


# ------------------------- K3: plain version ----------------------------- #

def _stream_props(nt, k, interior, nbhd, seed):
    rng_np = np.random.RandomState(seed)
    return (rng_np.randint(0, interior, (nt, k)).astype(np.int32),
            rng_np.randint(0, nbhd, (nt, k)).astype(np.int32),
            rng_np.rand(nt, k).astype(np.float32),
            rng_np.rand(nt, k).astype(np.float32))


@pytest.mark.parametrize("hw,tile,species,nbhd,dtype", [
    ((32, 64), (8, 16), 5, 4, "int32"),
    ((16, 16), (8, 8), 3, 8, "int8"),
    ((24, 48), (8, 16), 8, 4, "int16"),
])
def test_plain_stream_round_matches_oracle(hw, tile, species, nbhd, dtype):
    """The plain K3 equals ``ref.escg_tile_round_ref`` (the vmapped
    ``sublattice.tile_update``), and so does the wrapper on the CPU."""
    grid = _grid(*hw, species, dtype, seed=5)
    dom = _dom(species)
    nt = (hw[0] // tile[0]) * (hw[1] // tile[1])
    props = _stream_props(nt, 57, (tile[0] - 2) * (tile[1] - 2), nbhd, 3)
    want = np.asarray(ref.escg_tile_round_ref(
        jnp.asarray(grid.numpy()), *map(jnp.asarray, props),
        jnp.asarray(dom), tile, 0.25, 0.6))
    tprops = [torch.from_numpy(a) for a in props]
    got = escg_update.escg_tile_round_plain(grid, *tprops,
                                            torch.from_numpy(dom), tile,
                                            0.25, 0.6)
    assert got.dtype == grid.dtype
    np.testing.assert_array_equal(got.numpy(), want)
    assert not torch.equal(got, grid)
    ops.reset_launches()
    wrapped = escg_update.escg_tile_round(
        grid, *tprops, torch.from_numpy(dom), torch.as_tensor(lattice.DIRS),
        tile, 0.25, 0.6)
    assert torch.equal(wrapped, got)
    assert ops.launches()["escg_tile_round"] == 0


@pytest.mark.parametrize("shift", [(5, 11), (0, 0), (1, 1), (7, 15)])
@pytest.mark.parametrize("roll_back", [True, False])
def test_escg_round_matches_reference_run_round(roll_back, shift):
    """``ops.escg_round`` (K3 with the shift fused into its tile load, then
    the optional roll-back) against the reference's plain round, which its
    Pallas ``ops.escg_round`` must equal; shifts 0, 1 and (th - 1,
    tw - 1) of the (8, 16) tile besides (5, 11)."""
    grid = _grid(16, 32, 3, seed=8)
    dom = _dom(3)
    props = _stream_props(4, 40, 84, 4, 9)
    want = jsublattice.run_round(
        jnp.asarray(grid.numpy()), jrng.ProposalBatch(*map(jnp.asarray,
                                                           props)),
        jnp.asarray(shift, jnp.int32), (8, 16), 0.3, 0.65,
        jnp.asarray(dom), roll_back=roll_back)
    got = ops.escg_round(grid, rng.ProposalBatch(*map(torch.from_numpy,
                                                      props)),
                         shift, torch.from_numpy(dom),
                         torch.as_tensor(lattice.DIRS), (8, 16), 0.3, 0.65,
                         roll_back=roll_back)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype,nbhd", [("int32", 4), ("int8", 8),
                                        ("int16", 4)])
@pytest.mark.parametrize("shift", [(0, 0), (1, 1), (15, 31), (1, 31),
                                   (-3, 40)])
def test_stream_round_shift_is_roll_then_plain(shift, dtype, nbhd):
    """The K3 wrapper given a shift (which its kernel fuses into the tile
    load) equals ``torch.roll`` by ``-shift`` followed by the plain K3,
    and launches nothing on the CPU."""
    grid = _grid(16, 32, 5, dtype, seed=10)
    dom = torch.from_numpy(_dom(5))
    props = [torch.from_numpy(a) for a in _stream_props(4, 61, 84, nbhd, 2)]
    want = escg_update.escg_tile_round_plain(
        torch.roll(grid, (-shift[0], -shift[1]), (0, 1)), *props, dom,
        (8, 16), 0.25, 0.6)
    ops.reset_launches()
    got = escg_update.escg_tile_round(grid, *props, dom,
                                      torch.as_tensor(lattice.DIRS), (8, 16),
                                      0.25, 0.6, shift)
    assert got.dtype == grid.dtype and torch.equal(got, want)
    assert ops.launches()["escg_tile_round"] == 0


@pytest.mark.parametrize("tile,cell_bytes,n_dom,want", [
    ((8, 32), 4, 4, (1, 32)),          # park3's stream-fed path
    ((16, 32), 1, 6, (1, 32)),
    ((5, 7), 2, 4, (1, 32)),
    ((64, 64), 4, 200, (4, 13)),       # int32 staging, fewer tiles a block
])
def test_stream_staging_sizes(tile, cell_bytes, n_dom, want):
    """K3 stages its tiles as K1 does, with its double-buffered proposal
    chunks beside each tile: both fit a block's shared memory."""
    stage, per_block = escg_update.staging(tile, cell_bytes, n_dom)
    assert (stage, per_block) == want
    row_bytes = 4 * -(-tile[1] * stage // 4)
    assert escg_update.PROPOSAL_BYTES_PER_TILE == \
        2 * 4 * (escg_update.CHUNK + escg_update.CHUNK_PAD) * 4
    per_tile = tile[0] * row_bytes + escg_update.PROPOSAL_BYTES_PER_TILE
    assert per_block * per_tile + 4 * n_dom <= fused.SMEM_BYTES
    if per_block < fused.TILES_PER_BLOCK:
        assert (per_block + 1) * per_tile + 4 * n_dom > fused.SMEM_BYTES


def test_stream_chunk_constants_match_source():
    """The chunk and padding the wrapper sizes shared memory with are the
    kernel's ``kChunk`` and ``kPad``."""
    src = (Path(build.CSRC) / "escg_update.cu").read_text()
    consts = dict(re.findall(r"constexpr int (kChunk|kPad) = (\d+);", src))
    assert (int(consts["kChunk"]), int(consts["kPad"])) == \
        (escg_update.CHUNK, escg_update.CHUNK_PAD)



def test_stream_round_rejects_bad_input():
    grid = _grid(16, 32, 3)
    dom = torch.from_numpy(_dom(3))
    dirs = torch.as_tensor(lattice.DIRS)
    props = [torch.from_numpy(a) for a in _stream_props(4, 8, 84, 4, 1)]
    with pytest.raises(ValueError, match="proposals"):
        escg_update.escg_tile_round(grid, *(p[:3] for p in props), dom,
                                    dirs, (8, 16), 0.2, 0.5)
    with pytest.raises(ValueError, match="cell"):
        escg_update.escg_tile_round(grid, props[0].long(), *props[1:], dom,
                                    dirs, (8, 16), 0.2, 0.5)
    with pytest.raises(ValueError, match="u_dom"):
        escg_update.escg_tile_round(grid, *props[:3], props[3].double(),
                                    dom, dirs, (8, 16), 0.2, 0.5)
    with pytest.raises(ValueError, match="divide"):
        escg_update.escg_tile_round(grid, *props, dom, dirs, (8, 12), 0.2,
                                    0.5)
    meta = [p.to("meta") for p in props]
    with pytest.raises(ValueError, match="CUDA"):
        escg_update.escg_tile_round(grid.to("meta"), *meta, dom.to("meta"),
                                    dirs.to("meta"), (8, 16), 0.2, 0.5)


# ------------------------- K4: plain version ----------------------------- #

@pytest.mark.parametrize("hw,species", [((8, 16), 3), ((32, 128), 5),
                                        ((17, 33), 8), ((64, 64), 1)])
def test_plain_density_matches_reference(hw, species):
    """Against the interpreted Pallas kernel and ``ref.density_ref``, on a
    lattice with labels above S (neither counts them)."""
    g = np.random.RandomState(hw[0]).randint(0, species + 3, size=hw)
    g = g.astype(np.int32)
    want = np.asarray(jops.density_counts(jnp.asarray(g), species))
    np.testing.assert_array_equal(want,
                                  np.asarray(ref.density_ref(g, species)))
    for dtype in (torch.int32, torch.int16, torch.int8):
        got = density.density_counts_plain(torch.from_numpy(g).to(dtype),
                                           species)
        assert got.dtype == torch.int32 and got.shape == (species + 1,)
        np.testing.assert_array_equal(got.numpy(), want)


def test_density_skips_negative_labels_like_the_pallas_kernel():
    g = np.array([[-1, 0, 1, 2], [3, -2, 1, 9]], np.int32)
    want = np.asarray(jops.density_counts(jnp.asarray(g), 3))
    got = ops.density_counts(torch.from_numpy(g), 3)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, [1, 2, 1, 1])


def test_lattice_counts_go_through_the_density_wrapper():
    grid = _grid(24, 40, 5, "int8", seed=2)
    ops.reset_launches()
    got = lattice.counts(grid, 5)
    want = jmetrics.counts(jnp.asarray(grid.numpy()), 5)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert ops.launches()["density_counts"] == 0
    with pytest.raises(ValueError, match="dtype"):
        ops.density_counts(grid.long(), 5)
    with pytest.raises(ValueError, match="CUDA"):
        ops.density_counts(grid.to("meta"), 5)


@pytest.mark.parametrize("view", ["transposed", "strided", "meta"])
def test_density_rejects_a_non_contiguous_grid(view):
    """K4 reads a contiguous run of cells: a view that is not one raises
    ``ValueError``, on the CPU as on the card, while a contiguous view
    that starts inside its storage is counted like a copy."""
    grid = _grid(24, 40, 5, "int16", seed=3)
    bad = {"transposed": grid.t(), "strided": grid[:, ::2],
           "meta": grid.to("meta")[:, 1:]}[view]
    with pytest.raises(ValueError, match="contiguous"):
        ops.density_counts(bad, 5)
    inner = grid.reshape(-1)[1:]
    assert inner.is_contiguous() and inner.storage_offset() == 1
    np.testing.assert_array_equal(
        ops.density_counts(inner, 5).numpy(),
        density.density_counts_plain(inner.clone(), 5).numpy())


# ------------------------- K5: plain version ----------------------------- #

@pytest.mark.parametrize("n", [1, 4, 1000, 4099, 8192])
@pytest.mark.parametrize("seed,stream", [((0, 0), 0), ((0xDEADBEEF, 7), 3)])
def test_plain_philox_bits_match_reference(n, seed, stream):
    """Against the interpreted Pallas kernel and ``ref.philox_bits_ref``;
    4099 is ragged (not a multiple of 4 * block)."""
    want = np.asarray(jops.philox_bits(n, seed=seed, stream=stream,
                                       block=256))
    np.testing.assert_array_equal(
        want, ref.philox_bits_ref(n, seed, stream=stream, block=256))
    got = philox.philox_bits(n, seed, stream, 256, device="cpu")
    assert got.dtype == torch.uint32 and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), want)
    u_want = np.asarray(jops.philox_uniform(n, seed=seed, stream=stream,
                                            block=256))
    u = philox.philox_uniform(n, seed, stream, 256, device="cpu")
    assert u.dtype == torch.float32
    np.testing.assert_array_equal(u.numpy(), u_want)


def test_philox_block_does_not_change_the_words():
    a = philox.philox_bits(3001, (1, 2), 1, 1024, device="cpu")
    b = philox.philox_bits(3001, (1, 2), 1, 64, device="cpu")
    assert torch.equal(a, b)
    u = philox.philox_uniform(200_000, (1, 2), device="cpu")
    assert 0.0 <= float(u.min()) and float(u.max()) < 1.0
    assert philox.philox_bits(0, (1, 2), device="cpu").shape == (0,)
    with pytest.raises(ValueError, match="block"):
        philox.philox_bits(8, (1, 2), block=0, device="cpu")
    assert ops.launches()["philox_bits"] == 0


def test_philox_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (ops.philox_bits, ops.philox_uniform):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(16, (1, 2))
