"""The port's domain-decomposed ``sharded`` engine against the JAX package.

On the CPU a mesh is a list of ``cpu`` entries, the counterpart of the
reference's fake host devices, and every kernel wrapper takes its plain
version. Each piece is held to its JAX function on the same numpy inputs:
the halo copies to a global torus roll, ``auto_shard_grid``/
``lattice_mesh`` to the reference's, ``density_counts_sharded`` to the
gathered lattice's histogram, and ``simulate`` on ``sharded`` to the
reference's ``sublattice`` engine (``local_kernel`` 'jnp' and 'pallas')
or to the fused golden and the port's ``pallas_fused`` ('fused'), whose
JAX Pallas path does not run on the installed JAX. One subprocess with 8
fake JAX devices holds the port to the reference's own sharded functions.
Every comparison is exact, under ``jax.threefry_partitionable(False)``.
"""
import hashlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engines as jengines
from repro.core import rng as jrng
from repro.core import scenarios as jscenarios
from repro.core import sublattice as jsublattice
from repro.core.simulation import simulate as jsimulate
from repro.parallel import sharding as jsharding
from repro_torch.core import engines, sharded, threefry
from repro_torch.core.params import EscgParams
from repro_torch.core.rng import ProposalBatch
from repro_torch.core.scenarios import EngineConfig, RunConfig, make_scenario
from repro_torch.core.simulation import simulate
from repro_torch.kernels import density
from repro_torch.kernels import escg_update_fused as fused
from repro_torch.parallel import sharding

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FUSED_GOLDEN = os.path.join(REPO, "tests", "golden", "fused_trajectory.json")
ALL_OBS = ("densities", "interface_length", "cluster_size", "snapshot")
MESHES = [(1, 1), (2, 1), (1, 2), (2, 2)]


def _cpus(n):
    return ["cpu"] * n


def _mesh(shard_grid, h, w, tile):
    return sharding.lattice_mesh(shard_grid, h, w, *tile,
                                 devices=_cpus(shard_grid[0] * shard_grid[1]))


def _grid_hash(grid) -> str:
    """The goldens' digest: little-endian int32 raster bytes."""
    return hashlib.sha256(np.ascontiguousarray(
        np.asarray(grid).astype("<i4")).tobytes()).hexdigest()


def _random_grid(h, w, species, seed, dtype=np.int32):
    return np.random.RandomState(seed).randint(
        0, species + 1, size=(h, w)).astype(dtype)


# ------------------------------ halo copies ------------------------------ #

@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_halo_roll_matches_global_roll(n, axis):
    """The ring of ``n`` blocks along one mesh axis rolled by ``-s`` (and
    ``+s`` reversed) equals ``torch.roll`` of the whole lattice, for
    random shifts below the halo; the round trip restores the blocks."""
    extent, halo = 6, 5
    shape = [7, 7]
    shape[axis] = n * extent
    grid = torch.from_numpy(_random_grid(*shape, 9, seed=n + 10 * axis))
    blocks = list(torch.split(grid, extent, dim=axis))
    for s in np.random.RandomState(n).randint(0, halo, size=6).tolist():
        fwd = sharded.halo_roll(blocks, s, halo, axis)
        assert all(b.is_contiguous() for b in fwd)
        assert torch.equal(torch.cat(fwd, axis), torch.roll(grid, -s, axis))
        rev = sharded.halo_roll(blocks, s, halo, axis, reverse=True)
        assert torch.equal(torch.cat(rev, axis), torch.roll(grid, s, axis))
        back = sharded.halo_roll(fwd, s, halo, axis, reverse=True)
        assert torch.equal(torch.cat(back, axis), grid)


def test_halo_roll_keeps_its_precondition():
    blocks = list(torch.zeros((12, 4), dtype=torch.int32).split(4))
    for s, halo in ((4, 4), (-1, 4), (2, 5)):
        with pytest.raises(ValueError, match="0 <= s < halo"):
            sharded.halo_roll(blocks, s, halo, 0)


@pytest.mark.parametrize("cols", [1, 2, 3, 4])
@pytest.mark.parametrize("rows", [1, 2, 3, 4])
def test_shard_shift2d_matches_global_roll(rows, cols):
    """Rows then columns, each block's window from its halo copies: the
    gathered lattice is the global torus roll by ``-shift`` (``+shift``
    reversed) for random shifts, and a round trip restores it."""
    h, w, tile = 48, 96, (4, 8)
    grid = torch.from_numpy(_random_grid(h, w, 5, seed=rows * 5 + cols))
    lat = sharded.place(grid, _mesh((rows, cols), h, w, tile))
    rng_np = np.random.RandomState(rows * 7 + cols)
    for _ in range(4):
        shift = (int(rng_np.randint(tile[0])), int(rng_np.randint(tile[1])))
        fwd = sharded.shard_shift2d(lat, shift, tile)
        assert torch.equal(fwd.gather(),
                           torch.roll(grid, (-shift[0], -shift[1]), (0, 1)))
        rev = sharded.shard_shift2d(lat, shift, tile, reverse=True)
        assert torch.equal(rev.gather(), torch.roll(grid, shift, (0, 1)))
        back = sharded.shard_shift2d(fwd, shift, tile, reverse=True)
        assert torch.equal(back.gather(), grid)
        assert all(b.shape == lat.blocks[0][0].shape for b in back.flat)


def test_place_and_gather_round_trip():
    grid = torch.from_numpy(_random_grid(24, 40, 3, seed=2, dtype=np.int8))
    lat = sharded.place(grid, _mesh((3, 5), 24, 40, (4, 4)))
    assert lat.mesh.shape == (3, 5) and lat.shape == (24, 40)
    assert all(b.shape == (8, 8) and b.is_contiguous() for b in lat.flat)
    assert torch.equal(lat.blocks[1][2], grid[8:16, 16:24])
    assert torch.equal(lat.gather(), grid)
    views = lat.views()
    assert [v.offset for v in views][:6] == [(0, 0), (0, 8), (0, 16),
                                             (0, 24), (0, 32), (8, 0)]
    # block (0, 4)'s right neighbour wraps to block (0, 0), block (2, 1)'s
    # lower neighbour to block (0, 1)
    assert torch.equal(views[4].right, grid[0:8, 0:1])
    assert torch.equal(views[11].down, grid[0:1, 8:16])


# ------------------------------ mesh layout ------------------------------ #

@pytest.mark.parametrize("n_devices", [1, 2, 3, 4, 5, 6, 7, 8])
def test_auto_shard_grid_matches_reference(n_devices):
    for h in (16, 24, 48, 96, 100):
        for w in (16, 24, 48, 96, 100):
            for th, tw in ((4, 4), (8, 16), (3, 5), (8, 8)):
                assert sharding.auto_shard_grid(n_devices, h, w, th, tw) == \
                    jsharding.auto_shard_grid(n_devices, h, w, th, tw)


def test_lattice_mesh_matches_reference():
    """On the one JAX device here: the automatic grid, the raster order
    of the devices given, and the reference's refusal of a grid that needs
    more devices than it was given (the mesh is never shrunk)."""
    devs = jax.devices()[:1]
    for h, w, th, tw in ((16, 32, 8, 8), (48, 96, 4, 8), (24, 24, 3, 3)):
        jm = jsharding.lattice_mesh(None, h, w, th, tw, devices=devs)
        m = sharding.lattice_mesh(None, h, w, th, tw, devices="cpu")
        assert m.shape == (jm.shape["rows"], jm.shape["cols"])
    with pytest.raises(ValueError) as want:
        jsharding.lattice_mesh((2, 2), 16, 16, 8, 8, devices=devs)
    with pytest.raises(ValueError) as got:
        sharding.lattice_mesh((2, 2), 16, 16, 8, 8, devices="cpu")
    assert str(got.value) == str(want.value)
    m = sharding.lattice_mesh(None, 48, 96, 4, 8, devices=_cpus(6))
    assert m.shape == jsharding.auto_shard_grid(6, 48, 96, 4, 8) == (2, 3)
    m = sharding.lattice_mesh((1, 2), 16, 16, 8, 8,
                              devices=["cpu", torch.device("cpu"), "cpu"])
    assert m.devices == ((torch.device("cpu"),) * 2,)
    with pytest.raises(ValueError, match="dims must be >= 1"):
        sharding.lattice_mesh((0, 2), 16, 16, 8, 8, devices=_cpus(2))


# ------------------------ K4 on a decomposed lattice ----------------------- #

@pytest.mark.parametrize("dtype", [torch.int8, torch.int16, torch.int32])
@pytest.mark.parametrize("species", [3, 15, 16, 40])
def test_density_counts_sharded_equals_gathered(species, dtype):
    """On every mesh that divides a 32 x 48 lattice, with labels outside
    0..S too (not counted) and S on both sides of K4's 16 register bins:
    the sum of the blocks' K4 equals K4 and the plain count of the whole
    lattice, and numpy's histogram."""
    raw = np.random.RandomState(species).randint(-2, species + 4,
                                                 size=(32, 48))
    grid = torch.from_numpy(raw).to(dtype)
    valid = raw[(raw >= 0) & (raw <= species)]
    want = np.bincount(valid, minlength=species + 1)
    assert np.array_equal(density.density_counts(grid, species).numpy(),
                          want)
    assert np.array_equal(
        density.density_counts_plain(grid, species).numpy(), want)
    for rows in (1, 2, 4, 8, 16, 32):
        for cols in (1, 2, 3, 4, 6, 8, 12, 16, 24, 48):
            lat = sharded.place(grid, _mesh((rows, cols), 32, 48, (1, 1)))
            got = density.density_counts_sharded(lat.flat, species)
            assert got.dtype == torch.int32 and got.shape == (species + 1,)
            assert np.array_equal(got.numpy(), want), (rows, cols)


def test_density_counts_sharded_needs_a_block():
    with pytest.raises(ValueError, match="at least one block"):
        density.density_counts_sharded([], 3)


def test_density_counts_sharded_rejects_unequal_blocks():
    """K4s counts a device's blocks in one launch of one length and type,
    as a mesh's blocks are: other blocks are refused on every device."""
    a = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="equal in size and type"):
        density.density_counts_sharded([a, a[:2].contiguous()], 3)
    with pytest.raises(ValueError, match="equal in size and type"):
        density.density_counts_sharded([a, a.to(torch.int8)], 3)


# ------------------------- the engine: validation ------------------------ #

def test_engine_caps_match_reference():
    caps, jcaps = engines.get_engine("sharded").caps, \
        jengines.get_engine("sharded").caps
    for name in ("flux_only", "tiled", "multi_device", "mesh_axes",
                 "local_kernels", "multi_mcs", "equiv_oracle",
                 "equiv_oracles"):
        assert getattr(caps, name) == getattr(jcaps, name), name
    for lk in ("jnp", "pallas", "fused"):
        assert caps.oracle_for(lk) == jcaps.oracle_for(lk)
    assert "sharded" in engines.engine_names()
    assert "sharded" not in engines.NOT_PORTED


def _sharded_params(**kw):
    base = dict(length=32, height=16, engine="sharded", tile=(8, 8),
                species=3)
    base.update(kw)
    return EscgParams(**base)


def _jax_params(p):
    from repro.core import EscgParams as JaxParams
    return JaxParams.from_json(p.to_json())


def test_infeasible_shard_grid_raises_as_reference():
    """3 does not divide 16 rows into blocks of whole tiles: the
    reference's message (its one device refuses the mesh before that)."""
    p = _sharded_params(shard_grid=(3, 1))
    with pytest.raises(ValueError):
        jengines.build(_jax_params(p), jnp.eye(4))
    with pytest.raises(ValueError) as got:
        engines.build(p, device=_cpus(3))
    assert str(got.value) == ("device blocks (5x32) must be unions of 8x8 "
                              "tiles")


@pytest.mark.parametrize("kw,match", [
    (dict(local_kernel="cuda"), "local_kernel"),
    (dict(mesh_shape=(1, 1, 1)), "pod-composable"),
    (dict(local_kernel="jnp", k_mcs=2), "local_kernel='fused'"),
    (dict(shard_grid=(0, 1)), "dims must be >= 1"),
])
def test_invalid_params_raise_as_reference(kw, match):
    p = _sharded_params(**kw)
    with pytest.raises(ValueError, match=match):
        _jax_params(p).validate()
    with pytest.raises(ValueError, match=match):
        p.validate()


def test_mesh_needing_more_devices_than_given_raises():
    p = _sharded_params(shard_grid=(2, 2))
    for device in ("cpu", _cpus(3)):
        with pytest.raises(ValueError, match="needs 4 devices; only"):
            engines.build(p, device=device)
    with pytest.raises(ValueError, match="needs 4 devices; only 1"):
        simulate(make_scenario("park3"),
                 engine=EngineConfig(engine="sharded", tile=(8, 8),
                                     shard_grid=(2, 2)),
                 run=RunConfig(length=16, height=16, mcs=1), device="cpu")


def test_single_device_engines_refuse_a_device_list():
    with pytest.raises(ValueError, match="multi-device engine"):
        engines.build(_sharded_params(engine="pallas"), device=_cpus(2))


def test_no_card_raises_the_device_error(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, ["cuda:0"] * 4):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            simulate(make_scenario("park3"),
                     engine=EngineConfig(engine="sharded", tile=(8, 8),
                                         shard_grid=(2, 2)),
                     run=RunConfig(length=16, height=16, mcs=1),
                     device=device)


# --------------------- the engine: jnp / pallas families ------------------- #

_SUB = {}


def _jax_sublattice(species, dtype):
    """The reference's ``sublattice`` engine through its ``simulate``."""
    key = (species, dtype)
    if key not in _SUB:
        with jax.threefry_partitionable(False):
            _SUB[key] = jsimulate(
                jscenarios.make_scenario(f"nspecies{species}",
                                         mobility=2e-3, empty=0.1),
                engine=jscenarios.EngineConfig(engine="sublattice",
                                               tile=(8, 8),
                                               cell_dtype=dtype),
                run=jscenarios.RunConfig(length=32, height=16, mcs=5,
                                         chunk_mcs=3, seed=4,
                                         observables=()),
                stop_on_stasis=False)
    return _SUB[key]


@pytest.mark.parametrize("dtype", ["int8", "int32"])
@pytest.mark.parametrize("species", [3, 5])
@pytest.mark.parametrize("shard_grid", MESHES)
@pytest.mark.parametrize("local_kernel", ["jnp", "pallas"])
def test_simulate_matches_jax_sublattice(local_kernel, shard_grid, species,
                                         dtype):
    """Final lattice, every density row, ``kept_fraction`` and the MCS
    count equal the reference's ``sublattice`` engine for every mesh."""
    want = _jax_sublattice(species, dtype)
    res = simulate(make_scenario(f"nspecies{species}", mobility=2e-3,
                                 empty=0.1),
                   engine=EngineConfig(engine="sharded", tile=(8, 8),
                                       cell_dtype=dtype,
                                       shard_grid=shard_grid,
                                       local_kernel=local_kernel),
                   run=RunConfig(length=32, height=16, mcs=5, chunk_mcs=3,
                                 seed=4, observables=()),
                   stop_on_stasis=False, device=_cpus(4))
    assert res.grid.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(res.grid, want.grid)
    np.testing.assert_array_equal(res.densities, want.densities)
    assert (res.mcs_completed, res.stasis_mcs, res.kept_fraction) == \
        (want.mcs_completed, want.stasis_mcs, want.kept_fraction)


def test_matches_jax_sharded_functions_on_fake_devices(subproc):
    """In one process with 8 fake JAX devices: the port's sharded engine
    ('jnp', four cpu entries) equals the reference's sharded engine on a
    (2, 2) mesh of fake devices (lattice, densities, observables,
    ``kept_fraction``); ``density_counts_sharded`` equals the reference's
    on a (2, 4) mesh; ``lattice_mesh`` picks the reference's grids."""
    out = subproc("""
        import jax
        jax.config.update("jax_threefry_partitionable", False)
        import jax.numpy as jnp, numpy as np, torch
        from repro.core import scenarios as jsc
        from repro.core.simulation import simulate as jsimulate
        from repro.kernels.density import density_counts_sharded as jdcs
        from repro.parallel.sharding import lattice_mesh as jmesh
        from repro_torch.core import sharded
        from repro_torch.core.scenarios import (EngineConfig, RunConfig,
                                                make_scenario)
        from repro_torch.core.simulation import simulate
        from repro_torch.kernels.density import density_counts_sharded
        from repro_torch.parallel.sharding import lattice_mesh

        obs = ("densities", "interface_length", "cluster_size", "snapshot")
        want = jsimulate(
            jsc.make_scenario("nspecies5", mobility=2e-3, empty=0.1),
            engine=jsc.EngineConfig(engine="sharded", tile=(8, 8),
                                    shard_grid=(2, 2), local_kernel="jnp"),
            run=jsc.RunConfig(length=32, height=32, mcs=4, chunk_mcs=3,
                              seed=6, observables=obs),
            stop_on_stasis=False)
        got = simulate(
            make_scenario("nspecies5", mobility=2e-3, empty=0.1),
            engine=EngineConfig(engine="sharded", tile=(8, 8),
                                shard_grid=(2, 2), local_kernel="jnp"),
            run=RunConfig(length=32, height=32, mcs=4, chunk_mcs=3,
                          seed=6, observables=obs),
            stop_on_stasis=False, device=["cpu"] * 4)
        assert np.array_equal(got.grid, np.asarray(want.grid))
        for name in obs:
            assert np.array_equal(got.observables[name],
                                  want.observables[name]), name
        assert got.kept_fraction == want.kept_fraction

        grid = np.random.RandomState(3).randint(-1, 9, size=(32, 48))
        grid = grid.astype(np.int32)
        mesh = jmesh((2, 4), 32, 48, 8, 8)
        placed = jax.device_put(jnp.asarray(grid), jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec("rows", "cols")))
        jcounts = np.asarray(jdcs(placed, 7, mesh, interpret=True))
        lat = sharded.place(torch.from_numpy(grid),
                            lattice_mesh((2, 4), 32, 48, 8, 8,
                                         devices=["cpu"] * 8))
        assert np.array_equal(
            density_counts_sharded(lat.flat, 7).numpy(), jcounts)

        for n in range(1, 9):
            for h, w, th, tw in ((32, 48, 8, 8), (48, 96, 4, 8),
                                 (24, 40, 3, 5), (64, 64, 8, 16)):
                jm = jmesh(None, h, w, th, tw, devices=jax.devices()[:n])
                m = lattice_mesh(None, h, w, th, tw, devices=["cpu"] * n)
                assert m.shape == (jm.shape["rows"], jm.shape["cols"])
        print("SHARDED_MATCH")
    """, n_devices=8)
    assert "SHARDED_MATCH" in out


# ---------------------------- the fused family ---------------------------- #

@pytest.mark.parametrize("k_mcs", [1, 3])
@pytest.mark.parametrize("shard_grid", MESHES)
def test_fused_reproduces_the_golden(shard_grid, k_mcs):
    """The fused golden's config (16 x 16, tile (8, 8), seed 11, RPSLS) on
    every feasible mesh: every per-MCS grid hash, the densities and the
    final hash; with ``k_mcs=3`` also in one chunk of 5 MCS (a launch
    group of 3 and one of 2)."""
    with open(FUSED_GOLDEN) as f:
        want = json.load(f)

    def run(chunk, hooks=()):
        return simulate(make_scenario("nspecies5", mobility=1e-3, empty=0.1),
                        engine=EngineConfig(engine="sharded", tile=(8, 8),
                                            shard_grid=shard_grid,
                                            local_kernel="fused",
                                            k_mcs=k_mcs),
                        run=RunConfig(length=16, height=16, mcs=5,
                                      chunk_mcs=chunk, seed=11,
                                      observables=()),
                        stop_on_stasis=False, device=_cpus(4), hooks=hooks)
    hashes = []
    res = run(1, [lambda m, g, c: hashes.append(_grid_hash(g.numpy()))])
    assert hashes == want["grid_hashes"]
    for r in (res, run(5)):
        assert _grid_hash(r.grid) == want["final_hash"]
        np.testing.assert_array_equal(r.densities,
                                      np.asarray(want["densities"]))
        assert r.kept_fraction == want["kept_fraction"]


def test_fused_runs_k1_per_block_with_global_tile_ids(monkeypatch):
    """Each MCS of 'fused' on a (2, 2) mesh is one call of K1's table form
    over the four blocks, each read from the block extended by its halo
    with the block's ``tile_offset`` and the global tile width; every
    count is K4 of one block; no ``torch.roll`` runs on the path."""
    real_table, real_counts, real_roll = (fused.escg_tile_round_fused_table,
                                          density.density_counts,
                                          torch.roll)
    calls, counted, rolls = [], [], [0]

    def recording_table(sources, seeds, shifts, offsets, block_shape,
                        *args):
        calls.append(([tuple(src.shape) for src in sources],
                      [tuple(off) for off in offsets], tuple(block_shape),
                      args[7]))
        return real_table(sources, seeds, shifts, offsets, block_shape,
                          *args)

    def recording_counts(grid, species):
        counted.append(tuple(grid.shape))
        return real_counts(grid, species)

    def counted_roll(*args, **kwargs):
        rolls[0] += 1
        return real_roll(*args, **kwargs)
    monkeypatch.setattr(fused, "escg_tile_round_fused_table",
                        recording_table)
    monkeypatch.setattr(density, "density_counts", recording_counts)
    monkeypatch.setattr(torch, "roll", counted_roll)
    simulate(make_scenario("park3"),
             engine=EngineConfig(engine="sharded", tile=(8, 16),
                                 shard_grid=(2, 2), local_kernel="fused"),
             run=RunConfig(length=64, height=32, mcs=3, chunk_mcs=2,
                           observables=()),
             stop_on_stasis=False, device=_cpus(4))
    # 32 x 64 in (8, 16) tiles: 4 x 4 global, 2 x 2 per 16 x 32 block,
    # each read with a halo of one tile: (1, 24, 48)
    assert len(calls) == 3
    for sources, offsets, block_shape, gw in calls:
        assert sources == [(1, 24, 48)] * 4
        assert sorted(offsets) == [(0, 0), (0, 2), (2, 0), (2, 2)]
        assert block_shape == (16, 32) and gw == 4
    assert counted == [(16, 32)] * (4 * (3 + 1))
    assert rolls[0] == 0


def test_fused_one_block_multi_mcs_is_one_k2_launch(monkeypatch):
    """On a (1, 1) mesh ``k_mcs`` runs K2 with the global tile width."""
    real = fused.escg_tile_rounds_fused
    widths = []

    def recording(*args):
        widths.append((args[1].shape[0], args[12]))
        return real(*args)
    monkeypatch.setattr(fused, "escg_tile_rounds_fused", recording)
    res = simulate(make_scenario("park3"),
                   engine=EngineConfig(engine="sharded", tile=(8, 16),
                                       shard_grid=(1, 1),
                                       local_kernel="fused", k_mcs=3),
                   run=RunConfig(length=64, height=32, mcs=5, chunk_mcs=5,
                                 observables=()),
                   stop_on_stasis=False, device="cpu")
    assert widths == [(3, 4), (2, 4)]
    want = simulate(make_scenario("park3"),
                    engine=EngineConfig(engine="pallas_fused", tile=(8, 16)),
                    run=RunConfig(length=64, height=32, mcs=5,
                                  observables=()),
                    stop_on_stasis=False, device="cpu")
    np.testing.assert_array_equal(res.grid, want.grid)
    np.testing.assert_array_equal(res.densities, want.densities)


# ------------------------------ observables ------------------------------ #

@pytest.mark.parametrize("local_kernel,k_mcs,shard_grid,hw,tile", [
    ("fused", 1, (2, 2), (32, 48), (8, 8)),
    ("fused", 3, (2, 2), (32, 48), (8, 8)),
    ("fused", 3, (2, 3), (32, 48), (8, 8)),
    ("fused", 3, (1, 1), (32, 48), (8, 8)),
    ("jnp", 1, (2, 3), (32, 48), (8, 8)),
    ("pallas", 1, (2, 2), (36, 40), (6, 5)),
])
def test_observables_equal_the_single_device_rows(local_kernel, k_mcs,
                                                  shard_grid, hw, tile):
    """All four observables, the lag-hold under ``k_mcs`` included, equal
    the single-device engine of the family bit for bit: bond counts from
    each block and a one-cell halo, the snapshot's histogram from each
    block (coarse cells that span blocks, on the (2, 3) mesh; rows the
    8 x 8 partition leaves out, at 36 x 40)."""
    single = "pallas_fused" if local_kernel == "fused" else "sublattice"
    h, w = hw

    def run(engine, device, **kw):
        return simulate(make_scenario("nspecies5", mobility=2e-3, empty=0.1),
                        engine=EngineConfig(engine=engine, tile=tile,
                                            k_mcs=k_mcs, **kw),
                        run=RunConfig(length=w, height=h, mcs=7, chunk_mcs=4,
                                      seed=2, observables=ALL_OBS),
                        stop_on_stasis=False, device=device)
    want = run(single, "cpu")
    got = run("sharded", _cpus(6), shard_grid=shard_grid,
              local_kernel=local_kernel)
    np.testing.assert_array_equal(got.grid, want.grid)
    assert set(got.observables) == set(ALL_OBS)
    for name in ALL_OBS:
        np.testing.assert_array_equal(got.observables[name],
                                      want.observables[name], err_msg=name)


def test_observable_without_a_block_form_reads_the_gathered_lattice():
    """A registered grid-derived observable with no ``block``/``finish``
    is computed on the gathered lattice, so it streams on a decomposed
    lattice as on one device."""
    from repro_torch.core import observables as obs
    obs.register_observable("probe_corner", width=lambda p: 2)(
        lambda grid, counts, p: torch.stack([grid[0, 0], grid[-1, -1]]))
    try:
        def run(engine, device, **kw):
            return simulate(make_scenario("nspecies3"),
                            engine=EngineConfig(engine=engine, tile=(8, 8),
                                                **kw),
                            run=RunConfig(length=32, height=32, mcs=3,
                                          observables=("probe_corner",
                                                       "cluster_size")),
                            stop_on_stasis=False, device=device)
        want = run("sublattice", "cpu")
        got = run("sharded", _cpus(4), shard_grid=(2, 2))
        for name in ("probe_corner", "cluster_size", "densities"):
            np.testing.assert_array_equal(got.observables[name],
                                          want.observables[name])
    finally:
        del obs._REGISTRY["probe_corner"]


# ------------------------- explicit-proposal round ------------------------ #

@pytest.mark.parametrize("roll_back", [True, False])
@pytest.mark.parametrize("local_kernel", ["jnp", "pallas"])
@pytest.mark.parametrize("shard_grid", [(1, 1), (2, 2), (4, 2), (2, 4)])
def test_sharded_run_round_matches_jax_run_round(shard_grid, local_kernel,
                                                 roll_back):
    """Proposals in global raster tile order from the reference's
    ``tile_stream_batch``; two rounds equal ``sublattice.run_round``."""
    h, w, tile = 32, 64, (8, 16)
    n_tiles = (h // tile[0]) * (w // tile[1])
    dom = make_scenario("nspecies5").dominance()
    mesh = _mesh(shard_grid, h, w, tile)
    grid = _random_grid(h, w, 5, seed=1)
    got = torch.from_numpy(grid)
    with jax.threefry_partitionable(False):
        key = jax.random.PRNGKey(sum(shard_grid))
        for _ in range(2):
            kp, ks, key = jax.random.split(key, 3)
            props = jrng.tile_stream_batch(
                kp, jnp.arange(n_tiles, dtype=jnp.int32), 61,
                (tile[0] - 2) * (tile[1] - 2), 4)
            shift = jrng.round_shift(ks, *tile)
            grid = np.asarray(jsublattice.run_round(
                jnp.asarray(grid), props, shift, tile, 0.3, 0.6,
                jnp.asarray(dom), roll_back=roll_back))
            t_props = ProposalBatch(
                *(torch.from_numpy(np.array(a)).to(dt) for a, dt in zip(
                    props, (torch.int32, torch.int32, torch.float32,
                            torch.float32))))
            got = sharded.sharded_run_round(
                got, t_props, np.asarray(shift).tolist(), tile, 0.3, 0.6,
                torch.from_numpy(dom), mesh, roll_back=roll_back,
                local_kernel=local_kernel)
            np.testing.assert_array_equal(got.numpy(), grid)


def test_sharded_run_round_refuses_blocks_that_split_tiles():
    mesh = _mesh((2, 3), 32, 64, (8, 16))
    props = ProposalBatch(*(torch.zeros((16, 4), dtype=dt) for dt in (
        torch.int32, torch.int32, torch.float32, torch.float32)))
    with pytest.raises(ValueError, match="unions of"):
        sharded.sharded_run_round(torch.zeros((32, 64), dtype=torch.int32),
                                  props, (0, 0), (8, 16), 0.3, 0.6,
                                  torch.eye(4), mesh)


@pytest.mark.parametrize("roll_back", [True, False])
def test_make_sharded_simulation_matches_single_device(roll_back):
    """The notebook wrapper on a (2, 4) mesh equals the reference's MCS
    loop of ``sublattice`` rounds, rolled back each MCS by default (the
    fixed frame) or left to drift."""
    h, w, tile = 32, 64, (8, 16)
    p = EscgParams(length=w, height=h, species=3, mobility=1e-3,
                   engine="sublattice", tile=tile, seed=0)
    dom = make_scenario("nspecies3").dominance()
    te, tem = p.action_thresholds()
    n_tiles = (h // tile[0]) * (w // tile[1])
    k_per = -(-p.n_cells // n_tiles)
    place, one_mcs = sharded.make_sharded_simulation(
        p, dom, _mesh((2, 4), h, w, tile), roll_back=roll_back)
    grid0 = _random_grid(h, w, 3, seed=5)
    got = place(torch.from_numpy(grid0))
    key = threefry.PRNGKey(0)
    want = jnp.asarray(grid0)
    with jax.threefry_partitionable(False):
        jkey = jax.random.PRNGKey(0)
        for _ in range(3):
            jkey, k = jax.random.split(jkey)
            kp, ks = jax.random.split(k)
            props = jrng.tile_stream_batch(
                kp, jnp.arange(n_tiles, dtype=jnp.int32), k_per,
                (tile[0] - 2) * (tile[1] - 2), 4)
            want = jsublattice.run_round(
                want, props, jrng.round_shift(ks, *tile), tile, te, tem,
                jnp.asarray(dom), roll_back=roll_back)
            key, k = threefry.split(key)
            got = one_mcs(got, k)
    assert isinstance(got, sharded.ShardedLattice)
    np.testing.assert_array_equal(got.gather().numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="tiled engine"):
        sharded.make_sharded_simulation(p.replace(engine="batched"), dom,
                                        _mesh((1, 1), h, w, tile))
