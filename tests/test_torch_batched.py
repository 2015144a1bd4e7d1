"""The port's default engine (``batched``, E2) against the JAX package:
the scatter-min arbitration window ``batched.run_proposals``, its
equality with the sequential engine that drops conflicts, the engine's
key schedule and sub-batches, the kept count carried through
``simulate``, the default engine and reflecting boundaries.

Inputs are made from numpy seeds and handed to both packages; every
comparison is exact, under ``jax.threefry_partitionable(False)`` as a
context manager.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:   # hermetic container: deterministic fallback sampler
    from _propcheck import given, settings, strategies as st

from repro.core import batched as jbatched
from repro.core import engines as jengines
from repro.core import scenarios as jscenarios
from repro.core.rng import ProposalBatch as JaxBatch
from repro.core.simulation import simulate as jsimulate
from repro_torch.core import batched, dominance, engines, reference
from repro_torch.core import threefry
from repro_torch.core.rng import ProposalBatch
from repro_torch.core.scenarios import (EngineConfig, RunConfig, compose,
                                        make_scenario)
from repro_torch.core.simulation import simulate

ALL_OBS = ("densities", "interface_length", "cluster_size", "snapshot")
H, W = 12, 20


def _window(seed, species, nbhd, b):
    """A numpy-seeded 12 x 20 lattice, its dominance matrix and a window
    of ``b`` proposals."""
    r = np.random.RandomState(seed)
    grid = np.where(r.uniform(size=(H, W)) < 0.2, 0,
                    r.randint(1, species + 1, (H, W))).astype(np.int32)
    dom = (dominance.circulant(species) if species > 1
           else dominance.from_dense(np.zeros((1, 1))))
    props = (r.randint(0, H * W, b).astype(np.int32),
             r.randint(0, nbhd, b).astype(np.int32),
             r.uniform(size=b).astype(np.float32),
             r.uniform(size=b).astype(np.float32))
    return grid, dom.astype(np.float32), props


def _port(grid, dom, props):
    return (torch.from_numpy(grid), torch.from_numpy(dom),
            ProposalBatch(*map(torch.from_numpy, props)))


@given(seed=st.integers(0, 10_000), species=st.integers(1, 6),
       nbhd=st.sampled_from([4, 8]), flux=st.booleans(),
       b=st.integers(1, 200))
@settings(max_examples=25, deadline=None)
def test_run_proposals_matches_reference(seed, species, nbhd, flux, b):
    """The arbitration window equals the reference's scatter-min window:
    lattice and kept count."""
    grid, dom, props = _window(seed, species, nbhd, b)
    want_g, want_k = jbatched.run_proposals(
        jnp.asarray(grid), JaxBatch(*map(jnp.asarray, props)), 0.25, 0.65,
        jnp.asarray(dom), flux)
    g, d, batch = _port(grid, dom, props)
    got_g, got_k = batched.run_proposals(g, batch, 0.25, 0.65, d, flux)
    assert got_g.shape == (H, W) and got_k.dtype == torch.int32
    np.testing.assert_array_equal(got_g.numpy(), np.asarray(want_g))
    assert int(got_k) == int(want_k)


@given(seed=st.integers(0, 10_000), species=st.integers(1, 6),
       nbhd=st.sampled_from([4, 8]), flux=st.booleans(),
       b=st.integers(1, 200))
@settings(max_examples=25, deadline=None)
def test_batched_equals_sequential_drop(seed, species, nbhd, flux, b):
    """In the port too, E2 equals the sequential engine that drops
    conflicting proposals (the plain version of S1)."""
    grid, dom, props = _window(seed, species, nbhd, b)
    g, d, batch = _port(grid, dom, props)
    g_bat, k_bat = batched.run_proposals(g, batch, 0.25, 0.65, d, flux)
    g_seq, k_seq = reference.run_proposals(g, batch, 0.25, 0.65, d, flux,
                                           drop_conflicts=True)
    assert torch.equal(g_bat, g_seq)
    assert int(k_bat) == int(k_seq)


def test_conflict_free_window_keeps_every_proposal():
    """Disjoint proposals: the window equals the paper's Algorithm 3.2
    sequence and keeps all of them."""
    grid = np.random.RandomState(3).randint(0, 4, (16, 16)).astype(np.int32)
    cells = np.arange(0, 256, 4, dtype=np.int32)
    b = cells.size
    batch = ProposalBatch(
        torch.from_numpy(cells), torch.full((b,), 3, dtype=torch.int32),
        torch.from_numpy(np.linspace(0.01, 0.99, b).astype(np.float32)),
        torch.zeros(b, dtype=torch.float32))
    dom = torch.from_numpy(dominance.RPS())
    g = torch.from_numpy(grid)
    g_seq, _ = reference.run_proposals(g, batch, 0.3, 0.6, dom, True)
    g_bat, kept = batched.run_proposals(g, batch, 0.3, 0.6, dom, True)
    assert int(kept) == b
    assert torch.equal(g_seq, g_bat)


# ------------------------------- engine ---------------------------------- #

@pytest.mark.parametrize("n", [144, 240, 10_240_000, 6, 9, 7])
def test_sub_batches_match_reference(n):
    assert engines._pick_sub_batches(n) == jengines._pick_sub_batches(n)


@pytest.mark.parametrize("engine", ["batched", "reference"])
def test_engine_caps_match_reference(engine):
    caps, jcaps = engines.get_engine(engine).caps, \
        jengines.get_engine(engine).caps
    assert (caps.flux_only, caps.tiled, caps.multi_mcs,
            caps.equiv_oracle) == (jcaps.flux_only, jcaps.tiled,
                                   jcaps.multi_mcs, jcaps.equiv_oracle)
    with pytest.raises(ValueError, match="k_mcs"):
        compose(make_scenario("park3"), EngineConfig(engine=engine, k_mcs=2),
                RunConfig(length=16, height=16))


@pytest.mark.parametrize("engine", ["batched", "reference"])
def test_schedule_is_the_key_chain(engine):
    """Each MCS gets ``key_data(k1)`` of ``key, k1 = split(key)``; the
    shift is unused."""
    built = engines.build(compose(make_scenario("park3"),
                                  EngineConfig(engine=engine),
                                  RunConfig(length=16, height=12)),
                          device="cpu")
    key, words, shifts = built.schedule(threefry.PRNGKey(21), 4)
    with jax.threefry_partitionable(False):
        jkey = jax.random.PRNGKey(21)
        for t in range(4):
            jkey, k1 = jax.random.split(jkey)
            np.testing.assert_array_equal(
                words[t].numpy(), np.asarray(jax.random.key_data(k1)))
    np.testing.assert_array_equal(key.numpy(), np.asarray(jkey))
    assert not shifts.any()
    assert built.attempts_per_mcs == 16 * 12 and built.multi_mcs is None


@pytest.mark.parametrize("flux", [True, False])
def test_one_mcs_matches_reference_engine(flux):
    """One MCS of the engine (sub-batch keys from ``split(k1, n_sub)``,
    8 windows of 18 at 12 x 12) against the reference's ``one_mcs``."""
    sc = make_scenario("nspecies3", mobility=0.01,
                       boundary="flux" if flux else "reflect")
    p = compose(sc, EngineConfig(engine="batched"),
                RunConfig(length=12, height=12))
    built = engines.build(p, device="cpu")
    grid = np.random.RandomState(1).randint(0, 4, (12, 12)).astype(np.int32)
    words = [12345, 678]
    got_g, got_k = built.one_mcs(torch.from_numpy(grid), words, (0, 0))
    jsc = jscenarios.make_scenario("nspecies3", mobility=0.01,
                                   boundary="flux" if flux else "reflect")
    jp = jscenarios.compose(jsc, jscenarios.EngineConfig(engine="batched"),
                            jscenarios.RunConfig(length=12, height=12))
    with jax.threefry_partitionable(False):
        jbuilt = jengines.build(jp, jnp.asarray(jsc.dominance()))
        want_g, want_k, want_a = jbuilt.one_mcs(
            jnp.asarray(grid), jnp.asarray(words, jnp.uint32))
    np.testing.assert_array_equal(got_g.numpy(), np.asarray(want_g))
    assert got_k.device == got_g.device and int(got_k) == int(want_k)
    assert int(want_a) == 144 and int(got_k) < 144


# ------------------------------- simulate -------------------------------- #

_REF = {}


def _jax_run(species, flux, dtype):
    """The reference's ``batched`` engine through its ``simulate``, every
    observable on."""
    key = (species, flux, dtype)
    if key not in _REF:
        with jax.threefry_partitionable(False):
            _REF[key] = jsimulate(
                jscenarios.make_scenario(
                    f"nspecies{species}", mobility=2e-3, empty=0.1,
                    boundary="flux" if flux else "reflect"),
                engine=jscenarios.EngineConfig(engine="batched",
                                               cell_dtype=dtype),
                run=jscenarios.RunConfig(length=16, height=12, mcs=5,
                                         chunk_mcs=3, seed=4,
                                         observables=ALL_OBS),
                stop_on_stasis=False)
    return _REF[key]


@pytest.mark.parametrize("species", [3, 5])
@pytest.mark.parametrize("flux", [True, False])
@pytest.mark.parametrize("dtype", ["int8", "int32"])
@pytest.mark.parametrize("obs_on", [True, False])
def test_simulate_matches_jax_batched(species, flux, dtype, obs_on):
    """Final lattice, every density row, every observable stream and the
    kept fraction equal the reference's, and the kept fraction is below
    1: contested proposals were dropped and counted."""
    want = _jax_run(species, flux, dtype)
    res = simulate(make_scenario(f"nspecies{species}", mobility=2e-3,
                                 empty=0.1,
                                 boundary="flux" if flux else "reflect"),
                   engine=EngineConfig(engine="batched", cell_dtype=dtype),
                   run=RunConfig(length=16, height=12, mcs=5, chunk_mcs=3,
                                 seed=4,
                                 observables=ALL_OBS if obs_on else ()),
                   stop_on_stasis=False, device="cpu")
    assert res.grid.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(res.grid, want.grid)
    assert set(res.observables) == (set(ALL_OBS) if obs_on
                                    else {"densities"})
    for name, stream in res.observables.items():
        np.testing.assert_array_equal(stream, want.observables[name],
                                      err_msg=name)
    assert res.kept_fraction == want.kept_fraction
    assert 0.0 < res.kept_fraction < 1.0
    assert (res.mcs_completed, res.stasis_mcs) == (want.mcs_completed,
                                                   want.stasis_mcs)


def test_park3_runs_on_the_default_engine():
    """The plainest call: park3 with no engine named runs ``batched``,
    streams park3's declared observables, and equals the reference."""
    run = dict(length=16, height=16, mcs=2)
    res = simulate(make_scenario("park3"), run=RunConfig(**run),
                   device="cpu")
    with jax.threefry_partitionable(False):
        want = jsimulate(jscenarios.make_scenario("park3"),
                         run=jscenarios.RunConfig(**run))
    assert EngineConfig().engine == "batched"
    assert set(res.observables) == {"densities", "interface_length"}
    np.testing.assert_array_equal(res.grid, want.grid)
    for name in res.observables:
        np.testing.assert_array_equal(res.observables[name],
                                      want.observables[name])
    assert res.kept_fraction == want.kept_fraction < 1.0


@pytest.mark.parametrize("engine", ["batched", "reference"])
def test_reflecting_park3_runs(engine):
    """A reflecting park3 composes and runs on the two engines that take
    walls, and equals the reference's run."""
    sc = make_scenario("park3", boundary="reflect")
    run = dict(length=12, height=12, mcs=2, chunk_mcs=1)
    res = simulate(sc, engine=EngineConfig(engine=engine),
                   run=RunConfig(**run), device="cpu")
    with jax.threefry_partitionable(False):
        want = jsimulate(jscenarios.make_scenario("park3",
                                                  boundary="reflect"),
                         engine=jscenarios.EngineConfig(engine=engine),
                         run=jscenarios.RunConfig(**run))
    assert not compose(sc, EngineConfig(engine=engine),
                       RunConfig(**run)).flux
    np.testing.assert_array_equal(res.grid, want.grid)
    np.testing.assert_array_equal(res.densities, want.densities)
    assert res.kept_fraction == want.kept_fraction


@pytest.mark.parametrize("engine", ["pallas_fused", "pallas", "sublattice"])
def test_reflecting_park3_is_refused_by_flux_only_engines(engine):
    with pytest.raises(ValueError, match="flux-only"):
        compose(make_scenario("park3", boundary="reflect"),
                EngineConfig(engine=engine, tile=(8, 8)),
                RunConfig(length=16, height=16))
