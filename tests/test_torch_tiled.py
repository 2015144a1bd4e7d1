"""The port's stream-fed sublattice slice against the JAX package: batched
threefry keys, ``rng.tile_stream_batch``, ``sublattice.run_round``, the
``sublattice``/``pallas`` engines' key schedule, and ``simulate`` on both
engines against the reference's ``sublattice`` engine.

The reference's ``pallas`` engine reaches its Pallas kernel, which does
not run on the installed JAX; its ``equiv_oracle`` is ``sublattice``, so
both port engines are held to that. Every comparison is exact, under
``jax.threefry_partitionable(False)`` as a context manager.
"""
import inspect

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
from repro_torch.core import engines, rng, sublattice, threefry
from repro_torch.core.scenarios import (EngineConfig, RunConfig, Scenario,
                                        compose, make_scenario)
from repro_torch.core.simulation import simulate

ALL_OBS = ("densities", "interface_length", "cluster_size", "snapshot")


def _keys(n, seed=0):
    """n raw keys made from a numpy seed, as (n, 2) uint32."""
    rng_np = np.random.RandomState(seed)
    return rng_np.randint(0, 2 ** 32, size=(n, 2), dtype=np.uint64) \
        .astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


# ----------------------------- batched keys ------------------------------ #

@pytest.mark.parametrize("seed", [0, 7])
def test_fold_in_batch_is_vmap_of_fold_in(seed):
    key = _keys(1, seed)[0]
    data = np.concatenate([np.arange(5), [2 ** 31 - 1, 2 ** 32 - 1, 40_000]]
                          ).astype(np.uint32)
    with jax.threefry_partitionable(False):
        want = np.asarray(jax.vmap(
            lambda d: jax.random.fold_in(jnp.asarray(key), d))(
                jnp.asarray(data)))
    got = threefry.fold_in_batch(_t(key), _t(data))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("num", [2, 3, 4])
def test_split_batch_is_vmap_of_split(num):
    keys = _keys(9, num)
    with jax.threefry_partitionable(False):
        want = np.asarray(jax.vmap(lambda k: jax.random.split(k, num))(
            jnp.asarray(keys)))
    got = threefry.split_batch(_t(keys), num)
    assert got.shape == (9, num, 2)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("n", [1, 2, 7, 256])
def test_uniform_batch_is_vmap_of_uniform(n):
    keys = _keys(6, n)
    with jax.threefry_partitionable(False):
        want = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (n,)))(
            jnp.asarray(keys)))
    got = threefry.uniform_batch(_t(keys), n)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [1, 5, 256])
@pytest.mark.parametrize("lo,hi", [(0, 84), (0, 4), (0, 8), (-3, 70_000),
                                   (5, 5)])
def test_randint_batch_is_vmap_of_randint(n, lo, hi):
    keys = _keys(6, n + hi)
    with jax.threefry_partitionable(False):
        want = np.asarray(jax.vmap(
            lambda k: jax.random.randint(k, (n,), lo, hi, jnp.int32))(
                jnp.asarray(keys)))
    got = threefry.randint_batch(_t(keys), n, lo, hi)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_samplers_draw_on_the_keys_device():
    """No sampler defaults to the host: the draws land on the key's device
    unless another is named."""
    for fn in (threefry.random_bits, threefry.uniform, threefry.randint):
        assert inspect.signature(fn).parameters["device"].default is None
    key = threefry.PRNGKey(3)
    assert threefry.uniform(key, (4,)).device == key.device
    assert threefry.random_bits(key, (4,), device="meta").device.type \
        == "meta"
    props = rng.tile_stream_batch(key.to("meta"), torch.arange(3), 5, 84, 4)
    assert all(f.device.type == "meta" and f.shape == (3, 5)
               for f in props)


# ---------------------------- tile streams ------------------------------- #

@pytest.mark.parametrize("tile_ids,k,interior,nbhd", [
    (np.arange(8), 61, 84, 4),
    (np.arange(32), 128, 180, 8),
    (np.array([0, 5, 3, 39_999]), 256, 180, 4),
])
def test_tile_stream_batch_matches_reference(tile_ids, k, interior, nbhd):
    key = _keys(1, k)[0]
    with jax.threefry_partitionable(False):
        want = jrng.tile_stream_batch(jnp.asarray(key),
                                      jnp.asarray(tile_ids, jnp.int32), k,
                                      interior, nbhd)
    got = rng.tile_stream_batch(_t(key), torch.from_numpy(tile_ids), k,
                                interior, nbhd)
    for g, w in zip(got, want):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ------------------------------ run_round -------------------------------- #

@pytest.mark.parametrize("roll_back", [True, False])
@pytest.mark.parametrize("hw,tile,species,nbhd,dtype", [
    ((16, 32), (8, 16), 3, 4, "int32"),
    ((24, 24), (8, 8), 5, 8, "int8"),
])
def test_run_round_matches_reference(roll_back, hw, tile, species, nbhd,
                                     dtype):
    rng_np = np.random.RandomState(species)
    grid = rng_np.randint(0, species + 1, size=hw).astype(dtype)
    nt = (hw[0] // tile[0]) * (hw[1] // tile[1])
    interior = (tile[0] - 2) * (tile[1] - 2)
    k = 50
    props = (rng_np.randint(0, interior, (nt, k)).astype(np.int32),
             rng_np.randint(0, nbhd, (nt, k)).astype(np.int32),
             rng_np.rand(nt, k).astype(np.float32),
             rng_np.rand(nt, k).astype(np.float32))
    shift = (3, 5)
    dom = make_scenario(f"nspecies{species}").dominance()
    want = jsublattice.run_round(
        jnp.asarray(grid), jrng.ProposalBatch(*map(jnp.asarray, props)),
        jnp.asarray(shift, jnp.int32), tile, 0.2, 0.7, jnp.asarray(dom),
        roll_back=roll_back)
    got = sublattice.run_round(
        torch.from_numpy(grid), rng.ProposalBatch(*map(torch.from_numpy,
                                                       props)),
        shift, tile, 0.2, 0.7, torch.from_numpy(dom), roll_back=roll_back)
    assert got.dtype == torch.from_numpy(grid).dtype
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("tile", [(8, 16), (8, 32)])
def test_tiled_schedule_matches_reference_chain(tile):
    """The stream-fed engines' host chain: per MCS ``key, k1 =
    split(key)``, then ``kp, ks = split(k1)``; the launch takes
    ``key_data(kp)`` and ``round_shift(ks)``."""
    p = compose(make_scenario("park3"),
                EngineConfig(engine="pallas", tile=tile),
                RunConfig(length=64, height=32))
    built = engines.build(p, device="cpu")
    key, words, shifts = built.schedule(threefry.PRNGKey(21), 5)
    with jax.threefry_partitionable(False):
        jkey = jax.random.PRNGKey(21)
        for t in range(5):
            jkey, k1 = jax.random.split(jkey)
            kp, ks = jax.random.split(k1)
            np.testing.assert_array_equal(
                words[t].numpy(), np.asarray(jax.random.key_data(kp)))
            np.testing.assert_array_equal(
                shifts[t].numpy(), np.asarray(jrng.round_shift(ks, *tile)))
    np.testing.assert_array_equal(key.numpy(), np.asarray(jkey))
    assert built.attempts_per_mcs == p.n_cells
    assert built.multi_mcs is None


def test_engine_caps_match_reference():
    for name in ("sublattice", "pallas"):
        caps, jcaps = engines.get_engine(name).caps, \
            jengines.get_engine(name).caps
        assert (caps.flux_only, caps.tiled, caps.multi_mcs,
                caps.equiv_oracle) == (jcaps.flux_only, jcaps.tiled,
                                       jcaps.multi_mcs, jcaps.equiv_oracle)


# --------------------------- the whole slice ----------------------------- #

_REF = {}


def _jax_run(species, dtype, observables=ALL_OBS):
    """The reference's ``sublattice`` engine through its ``simulate``."""
    key = (species, dtype, observables)
    if key not in _REF:
        with jax.threefry_partitionable(False):
            _REF[key] = jsimulate(
                jscenarios.make_scenario(f"nspecies{species}",
                                         mobility=2e-3, empty=0.1),
                engine=jscenarios.EngineConfig(engine="sublattice",
                                               tile=(8, 16),
                                               cell_dtype=dtype),
                run=jscenarios.RunConfig(length=32, height=16, mcs=5,
                                         chunk_mcs=3, seed=4,
                                         observables=observables),
                stop_on_stasis=False)
    return _REF[key]


@pytest.mark.parametrize("engine", ["pallas", "sublattice"])
@pytest.mark.parametrize("species", [3, 5])
@pytest.mark.parametrize("dtype", ["int8", "int32"])
@pytest.mark.parametrize("obs_on", [True, False])
def test_simulate_matches_jax_sublattice(engine, species, dtype, obs_on):
    """Final lattice, every density row and every observable stream equal
    the reference's; with observables off the lattice and densities are
    the same as with them on."""
    want = _jax_run(species, dtype)
    res = simulate(make_scenario(f"nspecies{species}", mobility=2e-3,
                                 empty=0.1),
                   engine=EngineConfig(engine=engine, tile=(8, 16),
                                       cell_dtype=dtype),
                   run=RunConfig(length=32, height=16, mcs=5, chunk_mcs=3,
                                 seed=4,
                                 observables=ALL_OBS if obs_on else ()),
                   stop_on_stasis=False, device="cpu")
    assert res.grid.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(res.grid, want.grid)
    assert set(res.observables) == (set(ALL_OBS) if obs_on
                                    else {"densities"})
    for name, stream in res.observables.items():
        assert stream.shape == want.observables[name].shape, name
        np.testing.assert_array_equal(stream, want.observables[name],
                                      err_msg=name)
    assert (res.mcs_completed, res.stasis_mcs, res.kept_fraction) == \
        (want.mcs_completed, want.stasis_mcs, want.kept_fraction)


@pytest.mark.parametrize("engine", ["pallas", "sublattice"])
def test_park3_declared_observables_stream(engine):
    """park3 as users call it: its declared streams (densities,
    interface_length) come back without pinning ``observables``."""
    with jax.threefry_partitionable(False):
        want = jsimulate(jscenarios.make_scenario("park3"),
                         engine=jscenarios.EngineConfig(engine="sublattice",
                                                        tile=(8, 16)),
                         run=jscenarios.RunConfig(length=32, height=32,
                                                  mcs=4, chunk_mcs=2))
    res = simulate(make_scenario("park3"),
                   engine=EngineConfig(engine=engine, tile=(8, 16)),
                   run=RunConfig(length=32, height=32, mcs=4, chunk_mcs=2),
                   device="cpu")
    assert set(res.observables) == {"densities", "interface_length"}
    np.testing.assert_array_equal(res.grid, want.grid)
    for name in res.observables:
        np.testing.assert_array_equal(res.observables[name],
                                      want.observables[name])


def test_pallas_engine_fuses_its_shift_into_k3(monkeypatch):
    """Each MCS of the ``pallas`` engine is one K3 call given that MCS's
    torus shift, the schedule's; no ``torch.roll`` runs on the path outside
    K3's wrapper (whose CPU stand-in for the fused load is the only one),
    the park3 observables included."""
    from repro_torch.kernels import escg_update
    real_round, real_roll = escg_update.escg_tile_round, torch.roll
    shifts, outside, inside = [], [0], [False]

    def recording_round(*args, **kwargs):
        shifts.append(tuple(args[10]))      # ops.escg_round's shift
        inside[0] = True
        try:
            return real_round(*args, **kwargs)
        finally:
            inside[0] = False

    def counted_roll(*args, **kwargs):
        outside[0] += not inside[0]
        return real_roll(*args, **kwargs)
    monkeypatch.setattr(escg_update, "escg_tile_round", recording_round)
    monkeypatch.setattr(torch, "roll", counted_roll)
    scenario = make_scenario("park3")
    run = RunConfig(length=32, height=32, mcs=4, chunk_mcs=2)
    res = simulate(scenario, engine=EngineConfig(engine="pallas",
                                                 tile=(8, 16)),
                   run=run, stop_on_stasis=False, device="cpu")
    assert set(res.observables) == {"densities", "interface_length"}
    p = compose(scenario, EngineConfig(engine="pallas", tile=(8, 16)), run)
    key = threefry.split(threefry.PRNGKey(run.seed))[0]   # after grid0
    want = [tuple(int(v) for v in s) for s in
            engines.build(p, device="cpu").schedule(key, 4)[2]]
    assert shifts == want and any(s != (0, 0) for s in shifts)
    assert outside[0] == 0


@pytest.mark.parametrize("engine", ["pallas", "sublattice"])
def test_stasis_truncates_streams_like_reference(engine):
    """One species is stasis at the first MCS: ``stasis_mcs`` and the
    streams stop at the end of that chunk, as in the reference."""
    dom = np.zeros((2, 2), np.float32)
    with jax.threefry_partitionable(False):
        want = jsimulate(jscenarios.Scenario(species=1), dom,
                         engine=jscenarios.EngineConfig(engine="sublattice",
                                                        tile=(8, 8)),
                         run=jscenarios.RunConfig(length=16, height=16,
                                                  mcs=20, chunk_mcs=4,
                                                  observables=ALL_OBS))
    res = simulate(Scenario(species=1), dom,
                   engine=EngineConfig(engine=engine, tile=(8, 8)),
                   run=RunConfig(length=16, height=16, mcs=20, chunk_mcs=4,
                                 observables=ALL_OBS), device="cpu")
    assert (res.stasis_mcs, res.mcs_completed) == (want.stasis_mcs,
                                                   want.mcs_completed)
    for name in ALL_OBS:
        np.testing.assert_array_equal(res.observables[name],
                                      want.observables[name])
