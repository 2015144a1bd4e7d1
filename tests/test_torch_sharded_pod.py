"""The composed pod x grid engine ``sharded_pod`` of the port on the CPU,
held to the JAX package.

The mesh is a list of ``cpu`` entries (``device=["cpu"] * 8``), which
stands in for the reference's fake host devices: the port runs its plain
versions, one process driving every block. Held here:

* ``pod_lattice_mesh`` and the ``mesh_shape`` checks of
  ``validate_params``, message for message against the reference;
* ``run_trials(engine='sharded_pod', local_kernel='jnp')`` against the
  reference's own ``sharded_pod`` on 8 fake JAX devices (a subprocess per
  mesh, ``jax_threefry_partitionable`` off), padding included;
* ``'fused'`` against the port's ``pallas_fused`` trials and ``'pallas'``
  against ``sublattice`` for every factorization of 8 devices, ``k_mcs``
  1 and 10 (the reference's own claim, ``tests/test_properties.py``);
* observables on and off, the trial golden, ``simulate`` against
  ``sharded``, the halo of the batched round against the rolled lattice,
  and the table forms' plain versions against the reference's oracles.
"""
import itertools
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import EscgParams as JaxParams
from repro.core import metrics as jmetrics
from repro.kernels import ref
from repro.parallel import sharding as jsharding
from repro_torch.core import dominance as dm
from repro_torch.core import engines, lattice, sharded, threefry
from repro_torch.core.params import EscgParams
from repro_torch.core.scenarios import EngineConfig, RunConfig, make_scenario
from repro_torch.core.simulation import simulate
from repro_torch.core.trials import run_trials
from repro_torch.kernels import density, escg_update
from repro_torch.kernels import escg_update_fused as fused
from repro_torch.parallel.sharding import lattice_mesh, pod_lattice_mesh

TRIAL_GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "golden", "trial_result.json")
CPUS = ["cpu"] * 8
# every (P, R, C) with P * R * C = 8, and the one-device mesh
FACTORIZATIONS = [(1, 1, 1)] + [
    (p, r, 8 // (p * r)) for p in (1, 2, 4, 8) for r in (1, 2, 4, 8)
    if 8 % (p * r) == 0]
STATS = ("survival", "densities", "stasis_mcs", "extinction_mcs")


def _scenario():
    return make_scenario("nspecies5", mobility=2e-3, empty=0.1)


# ------------------------------- the mesh --------------------------------- #

@pytest.mark.parametrize("mesh_shape,hw,tile", [
    ((0, 1, 1), (16, 32), (8, 8)),
    ((3, 2, 2), (16, 32), (8, 8)),
    ((1, 3, 1), (16, 32), (8, 8)),
    ((1, 4, 1), (16, 32), (8, 8)),
    ((1, 1, 3), (16, 32), (8, 8)),
    ((2, 1, 4), (16, 48), (8, 8)),
])
def test_pod_lattice_mesh_refuses_as_the_reference(mesh_shape, hw, tile):
    """Each infeasible layout raises the reference's ``ValueError`` with
    its message, on eight devices."""
    with pytest.raises(ValueError) as want:
        jsharding.pod_lattice_mesh(mesh_shape, *hw, *tile,
                                   devices=[object()] * 8)
    with pytest.raises(ValueError) as got:
        pod_lattice_mesh(mesh_shape, *hw, *tile, devices=CPUS)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("mesh_shape", [None, (1, 1, 1), (2, 2, 2),
                                        (1, 2, 4), (3, 1, 1)])
def test_pod_lattice_mesh_lays_devices_in_raster_order(mesh_shape):
    """``None`` puts every device on the pod axis; the first P·R·C
    devices fill the mesh in raster order; ``group(g)`` is pod group g's
    ('rows', 'cols') mesh."""
    devs = [torch.device("cpu", i) for i in range(8)]
    m = pod_lattice_mesh(mesh_shape, 32, 64, 8, 16, devices=devs)
    want = (8, 1, 1) if mesh_shape is None else mesh_shape
    assert m.shape == want and m.first == devs[0]
    assert list(m.flat) == devs[:want[0] * want[1] * want[2]]
    for g in range(want[0]):
        assert m.group(g).shape == want[1:]
        assert m.group(g).flat == m.flat[g * want[1] * want[2]:
                                         (g + 1) * want[1] * want[2]]


@pytest.mark.parametrize("engine,mesh_shape", [
    ("sharded_pod", (2, 2)), ("sharded_pod", (2, 0, 1)),
    ("sharded", (1, 1, 1)), ("sublattice", (2, 1, 1))])
def test_mesh_shape_validation_matches_the_reference(engine, mesh_shape):
    kw = dict(engine=engine, tile=(8, 8), length=16, height=16,
              mesh_shape=mesh_shape)
    with pytest.raises(ValueError) as want:
        JaxParams(**kw).validate()
    with pytest.raises(ValueError) as got:
        EscgParams(**kw).validate()
    assert str(got.value) == str(want.value)


def test_registered_with_the_reference_caps():
    from repro.core import engines as jengines
    caps, jcaps = (engines.get_engine("sharded_pod").caps,
                   jengines.get_engine("sharded_pod").caps)
    for name in ("flux_only", "tiled", "multi_device", "vmappable",
                 "trial_shardable", "mesh_axes", "local_kernels",
                 "multi_mcs", "equiv_oracle", "equiv_oracles"):
        assert getattr(caps, name) == getattr(jcaps, name), name
    assert caps.pod_composable and caps.oracle_for("fused") == "pallas_fused"
    assert not engines.NOT_PORTED


# -------------------- the reference's own engine (jnp) -------------------- #

@pytest.mark.parametrize("mesh_shape", [(1, 1, 1), (2, 2, 2), (8, 1, 1),
                                        (1, 2, 4), (2, 1, 4)])
def test_jnp_matches_jax_sharded_pod_on_fake_devices(subproc, mesh_shape):
    """5 trials (padded to the pod width) with every observable: the
    port's ``'jnp'`` on eight ``cpu`` entries equals the reference's
    ``sharded_pod`` on eight fake devices in survival, densities, stasis
    and extinction MCS, ``mcs_completed``, the device count and every
    observable stream."""
    out = subproc(f"""
        import jax
        jax.config.update("jax_threefry_partitionable", False)
        import numpy as np
        from repro.core import scenarios as jsc
        from repro.core.trials import run_trials as jrun
        from repro_torch.core.scenarios import (EngineConfig, RunConfig,
                                                make_scenario)
        from repro_torch.core.trials import run_trials

        obs = ("densities", "interface_length", "cluster_size", "snapshot")
        kw = dict(n_trials=5, stop_on_stasis=False)
        want = jrun(jsc.make_scenario("nspecies5", mobility=2e-3,
                                      empty=0.1),
                    engine=jsc.EngineConfig(engine="sharded_pod",
                                            tile=(8, 16),
                                            mesh_shape={mesh_shape},
                                            local_kernel="jnp"),
                    run=jsc.RunConfig(length=64, height=32, mcs=4,
                                      chunk_mcs=3, seed=3, observables=obs),
                    **kw)
        got = run_trials(make_scenario("nspecies5", mobility=2e-3,
                                       empty=0.1),
                         engine=EngineConfig(engine="sharded_pod",
                                             tile=(8, 16),
                                             mesh_shape={mesh_shape},
                                             local_kernel="jnp"),
                         run=RunConfig(length=64, height=32, mcs=4,
                                       chunk_mcs=3, seed=3, observables=obs),
                         device=["cpu"] * 8, **kw)
        for f in {STATS!r}:
            assert np.array_equal(getattr(got, f),
                                  np.asarray(getattr(want, f))), f
        assert got.mcs_completed == want.mcs_completed
        assert got.n_devices == want.n_devices
        assert got.kept_fraction == want.kept_fraction
        for name in obs:
            assert np.array_equal(got.observables[name],
                                  np.asarray(want.observables[name])), name
        print("POD_MATCH")
    """, n_devices=8)
    assert "POD_MATCH" in out


# ------------------ every factorization, both oracles ---------------------- #

def _pod_trials(engine, device, k_mcs=1, **kw):
    return run_trials(_scenario(), n_trials=3,
                      engine=EngineConfig(engine=engine, tile=(4, 4),
                                          k_mcs=k_mcs, **kw),
                      run=RunConfig(length=32, height=32, mcs=10,
                                    chunk_mcs=10, seed=5, observables=()),
                      stop_on_stasis=False, device=device)


_ORACLES = {}


def _oracle(engine):
    if engine not in _ORACLES:
        _ORACLES[engine] = _pod_trials(engine, "cpu")
    return _ORACLES[engine]


def _same_trials(got, want):
    for f in STATS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert (got.mcs_completed, got.kept_fraction, got.n_trials) == \
        (want.mcs_completed, want.kept_fraction, want.n_trials)


@pytest.mark.parametrize("k_mcs", [1, 10])
@pytest.mark.parametrize("mesh_shape", FACTORIZATIONS)
def test_fused_equals_pallas_fused_for_every_factorization(mesh_shape,
                                                           k_mcs):
    got = _pod_trials("sharded_pod", CPUS, k_mcs, mesh_shape=mesh_shape,
                      local_kernel="fused")
    _same_trials(got, _oracle("pallas_fused"))
    assert got.n_devices == mesh_shape[0] * mesh_shape[1] * mesh_shape[2]


@pytest.mark.parametrize("mesh_shape", FACTORIZATIONS)
def test_pallas_equals_sublattice_for_every_factorization(mesh_shape):
    got = _pod_trials("sharded_pod", CPUS, mesh_shape=mesh_shape,
                      local_kernel="pallas")
    _same_trials(got, _oracle("sublattice"))


def test_default_mesh_puts_every_device_on_the_pod_axis():
    """``mesh_shape=None`` on three entries is (3, 1, 1): 3 trials pad to
    3, each a whole lattice, equal to ``pallas_fused``."""
    got = _pod_trials("sharded_pod", ["cpu"] * 3, local_kernel="fused")
    _same_trials(got, _oracle("pallas_fused"))
    assert got.n_devices == 3


@pytest.mark.parametrize("local_kernel", ["jnp", "pallas", "fused"])
def test_observables_on_equal_off(local_kernel):
    """Every observable streamed through the ring changes no trial, and
    the streams equal those of the single-device engine of the family."""
    oracle = "pallas_fused" if local_kernel == "fused" else "sublattice"
    obs = ("densities", "interface_length", "cluster_size", "snapshot")

    def run(engine, device, observables, **kw):
        return run_trials(_scenario(), n_trials=3,
                          engine=EngineConfig(engine=engine, tile=(8, 8),
                                              **kw),
                          run=RunConfig(length=32, height=32, mcs=5,
                                        chunk_mcs=3, seed=2,
                                        observables=observables),
                          stop_on_stasis=False, device=device)
    on = run("sharded_pod", CPUS, obs, mesh_shape=(2, 2, 2),
             local_kernel=local_kernel)
    off = run("sharded_pod", CPUS, (), mesh_shape=(2, 2, 2),
              local_kernel=local_kernel)
    _same_trials(on, off)
    assert not off.observables and sorted(on.observables) == sorted(obs)
    want = run(oracle, "cpu", obs)
    for name in obs:
        np.testing.assert_array_equal(on.observables[name],
                                      want.observables[name])


@pytest.mark.parametrize("local_kernel", ["jnp", "pallas"])
@pytest.mark.parametrize("mesh_shape", [(1, 2, 2), (2, 2, 1), (4, 1, 2)])
def test_reproduces_the_trial_golden(mesh_shape, local_kernel):
    """``tests/golden/trial_result.json`` (4 trials of a 16 x 16 lattice
    in (8, 8) tiles) on meshes the lattice admits; the device count is the
    mesh's."""
    with open(TRIAL_GOLDEN) as f:
        want = json.load(f)
    got = json.loads(run_trials(
        make_scenario("nspecies5", mobility=1e-3, empty=0.1), dm.RPSLS(),
        n_trials=4,
        engine=EngineConfig(engine="sharded_pod", tile=(8, 8),
                            mesh_shape=mesh_shape, local_kernel=local_kernel),
        run=RunConfig(length=16, height=16, seed=7, observables=()),
        n_mcs=6, chunk_mcs=3, stop_on_stasis=False, device=CPUS).to_json())
    assert got.pop("n_devices") == int(np.prod(mesh_shape))
    want.pop("n_devices")
    assert got == want


@pytest.mark.parametrize("local_kernel", ["jnp", "pallas", "fused"])
def test_simulate_equals_sharded(local_kernel):
    """``simulate`` runs pod group 0's grid: it equals ``sharded`` on that
    ('rows', 'cols') mesh, lattice and densities."""
    def run(**kw):
        return simulate(_scenario(), engine=EngineConfig(
            tile=(8, 8), local_kernel=local_kernel, **kw),
            run=RunConfig(length=32, height=16, mcs=4, chunk_mcs=3, seed=4,
                          observables=()),
            stop_on_stasis=False, device=["cpu"] * 8)
    got = run(engine="sharded_pod", mesh_shape=(2, 2, 2))
    want = run(engine="sharded", shard_grid=(2, 2))
    np.testing.assert_array_equal(got.grid, want.grid)
    np.testing.assert_array_equal(got.densities, want.densities)


def test_refuses_trial_devices_and_pads_to_the_pod_width():
    with pytest.raises(ValueError, match="not trial_devices"):
        run_trials(_scenario(), n_trials=2,
                   engine=EngineConfig(engine="sharded_pod", tile=(8, 8),
                                       mesh_shape=(2, 1, 1)),
                   run=RunConfig(length=16, height=16, mcs=1),
                   trial_devices=2, device=CPUS)
    built = engines.build(EscgParams(engine="sharded_pod", tile=(8, 8),
                                     length=16, height=16,
                                     mesh_shape=(4, 1, 2)), None, CPUS)
    assert built.pod_width == 4 and built.mesh.shape == (4, 1, 2)
    batch, keys = built.init_batch(threefry.fold_in_batch(
        threefry.PRNGKey(0), torch.arange(8)))
    assert keys.shape == (8, 2) and len(batch.groups) == 4
    assert batch.groups[0].blocks[0][0].shape == (2, 16, 8)


# ------------------------- the halo, on the host --------------------------- #

@pytest.mark.parametrize("grid_shape", [(1, 1), (2, 1), (1, 2), (2, 2),
                                        (3, 2)])
@pytest.mark.parametrize("shift", [(0, 0), (7, 15), (1, 0), (0, 15),
                                   (7, 1)])
def test_halo_windows_are_the_rolled_lattice(grid_shape, shift):
    """The window of every extended block at each trial's shift (below
    the tile) is that block of the lattice rolled by minus the shift,
    rows first then columns, as the reference's ``shard_shift2d``; the
    frame is never rolled back."""
    tile = (8, 16)
    h, w = 8 * 3 * grid_shape[0], 16 * 2 * grid_shape[1]
    gen = torch.Generator().manual_seed(h + w)
    grids = torch.randint(0, 9, (3, h, w), generator=gen, dtype=torch.int32)
    mesh = lattice_mesh(grid_shape, h, w, *tile,
                        devices=["cpu"] * (grid_shape[0] * grid_shape[1]))
    lat = sharded.place(grids, mesh)
    shifts = torch.tensor([shift, (0, 0), (tile[0] - 1, tile[1] - 1)],
                          dtype=torch.int64)
    rolled = sharded.place(torch.stack([
        torch.roll(g, (-int(dy), -int(dx)), (0, 1))
        for g, (dy, dx) in zip(grids, shifts.tolist())]), mesh)
    ext = sharded.halo_extend(lat, tile)
    bh, bw = h // grid_shape[0], w // grid_shape[1]
    for ri, ci in itertools.product(range(grid_shape[0]),
                                    range(grid_shape[1])):
        assert ext[ri][ci].shape[-2:] == (
            bh + (tile[0] if grid_shape[0] > 1 else 0),
            bw + (tile[1] if grid_shape[1] > 1 else 0))
        assert torch.equal(fused.halo_windows(ext[ri][ci], shifts, (bh, bw)),
                           rolled.blocks[ri][ci])
    assert torch.equal(lat.gather(), grids)


def test_decomposed_batch_views_give_trial_rows():
    """A decomposed trial batch's block partials give each trial's row:
    ``grid_values`` of the blocks equals that of the whole batch."""
    from repro_torch.core import observables as obs_mod
    p = EscgParams(engine="sharded_pod", tile=(8, 8), length=32, height=16,
                   species=5, observables=("interface_length",
                                           "cluster_size", "snapshot"))
    grids = lattice.init_grid(threefry.PRNGKey(1), 16, 32, 5, 0.1,
                              device="cpu")
    grids = torch.stack([grids, grids.flip(0), grids.flip(1)])
    pipe = obs_mod.build_pipeline(p)
    lat = sharded.place(grids, lattice_mesh((2, 2), 16, 32, 8, 8,
                                            devices=["cpu"] * 4))
    want = pipe.grid_values(grids)
    got = pipe.grid_values(lat)
    for name, v in want.items():
        assert got[name].shape == v.shape == (3, v.shape[-1])
        assert torch.equal(got[name], v), name


# -------------- the table forms' plain versions, against JAX --------------- #

def test_k1_table_plain_matches_the_oracle_per_block():
    """K1's table form keys each run's tiles by its offset in the global
    tile grid and reads each trial's window at its shift: equal to the
    reference's fused-proposal oracle on the rolled lattice's block."""
    tile, k, nbhd = (8, 16), 40, 8
    grid = lattice.init_grid(threefry.PRNGKey(3), 32, 64, 5, 0.1, device="cpu")
    dom = dm.circulant(5, (1, 2))
    mesh = lattice_mesh((2, 2), 32, 64, *tile, devices=["cpu"] * 4)
    lat = sharded.place(grid[None], mesh)
    ext = sharded.halo_extend(lat, tile)
    shift = (5, 11)
    seeds = torch.tensor([[7, 0xDEADBEEF]], dtype=torch.int64)
    shifts = torch.tensor([shift], dtype=torch.int64)
    runs = [(ri, ci) for ri in range(2) for ci in range(2)]
    got = fused.escg_tile_round_fused_table_plain(
        [ext[ri][ci] for ri, ci in runs], [seeds] * 4, [shifts] * 4,
        [(2 * ri, 2 * ci) for ri, ci in runs], (16, 32),
        torch.from_numpy(dom), tile, k, 0.25, 0.6, nbhd, 4)
    rolled = np.roll(grid.numpy(), (-shift[0], -shift[1]), (0, 1))
    cell, dirn, ua, ud = (np.asarray(a) for a in ref.fused_proposals_ref(
        16, k, (tile[0] - 2) * (tile[1] - 2), nbhd, (7, 0xDEADBEEF), 0))
    want = np.asarray(ref.escg_tile_round_ref(
        jnp.asarray(rolled), jnp.asarray(cell), jnp.asarray(dirn),
        jnp.asarray(ua), jnp.asarray(ud), jnp.asarray(dom), tile, 0.25,
        0.6))
    for (ri, ci), block in zip(runs, got):
        np.testing.assert_array_equal(
            block[0].numpy(), want[16 * ri:16 * ri + 16, 32 * ci:32 * ci + 32])


def test_k3_table_plain_matches_the_oracle_per_block():
    """K3's table form plays each run's proposals on each trial's window:
    equal to the reference's tile oracle on the rolled lattice's block."""
    tile = (8, 8)
    grid = lattice.init_grid(threefry.PRNGKey(4), 16, 32, 3, 0.1, device="cpu")
    dom = dm.circulant(3)
    mesh = lattice_mesh((1, 2), 16, 32, *tile, devices=["cpu"] * 2)
    ext = sharded.halo_extend(sharded.place(grid[None], mesh), tile)
    shift = (3, 7)
    props = [sharded.tile_stream_batch(
        threefry.key_data(threefry.PRNGKey(9))[None],
        sharded._local_tile_ids(0, ci, (16, 16), tile, 4, "cpu"), 20, 36, 4)
        for ci in range(2)]
    got = escg_update.escg_tile_round_table_plain(
        [ext[0][0], ext[0][1]], props,
        [torch.tensor([shift], dtype=torch.int64)] * 2, (16, 16),
        torch.from_numpy(dom), tile, 0.3, 0.7)
    rolled = np.roll(grid.numpy(), (-shift[0], -shift[1]), (0, 1))
    whole = sharded.tile_stream_batch(
        threefry.key_data(threefry.PRNGKey(9)), torch.arange(8), 20, 36, 4)
    want = np.asarray(ref.escg_tile_round_ref(
        jnp.asarray(rolled), *(jnp.asarray(f.numpy()) for f in whole),
        jnp.asarray(dom), tile, 0.3, 0.7))
    for ci in range(2):
        np.testing.assert_array_equal(got[ci][0].numpy(),
                                      want[:, 16 * ci:16 * ci + 16])


@pytest.mark.parametrize("species", [3, 40])
def test_k4s_trials_plain_matches_the_reference_counts(species):
    """K4s per trial: each trial's counts of its group's blocks equal the
    reference's ``metrics.counts`` of the gathered trial."""
    gen = torch.Generator().manual_seed(species)
    grids = torch.randint(0, species + 1, (2, 3, 16, 24), generator=gen,
                          dtype=torch.int32)
    mesh = lattice_mesh((2, 3), 16, 24, 8, 8, devices=["cpu"] * 6)
    groups = [sharded.place(g, mesh).flat for g in grids]
    got = density.density_counts_sharded_trials(groups, species)
    want = np.stack([np.asarray(jmetrics.counts(jnp.asarray(g.numpy()),
                                                species))
                     for g in grids.reshape(6, 16, 24)])
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, density.density_counts_sharded_trials_plain(
        groups, species))
