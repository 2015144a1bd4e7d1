"""The port's trial driver (``repro_torch.core.trials``) against the JAX
package's, bit for bit, on the CPU.

Every comparison with JAX runs under ``jax.threefry_partitionable(False)``
(scoped, never the global flag). Densities are counts / N, so every
statistic is compared exactly. The behaviour tests mirror the reference's
``tests/test_trials.py``; the pod axis runs over ``device=["cpu"] * k``.
"""
import json
import os
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.core import EscgParams as JaxParams
from repro.core import dominance as jdm
from repro.core import park as jpark
from repro.core import scenarios as jscenarios
from repro.core import trials as jtrials
from repro_torch import convert
from repro_torch.core import (batched, dominance as dm, engines, lattice,
                              observables as obs, park, rng, scenarios,
                              sublattice, threefry)
from repro_torch.core.params import EscgParams
from repro_torch.core.scenarios import EngineConfig, RunConfig, make_scenario
from repro_torch.core.simulation import run_trials as legacy_run_trials
from repro_torch.core.simulation import simulate
from repro_torch.core.trials import (TrialResult, build_trial_chunk,
                                     fold_trial_keys, make_trial_init,
                                     pad_trials, pod_devices, run_trials,
                                     trial_grids_and_keys)
from repro_torch.kernels import density, escg_update, ops
from repro_torch.kernels import escg_update_fused as fused

TRIAL_GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "golden", "trial_result.json")
# tests/test_golden.py's frozen trial configuration
GOLDEN_KW = dict(length=16, height=16, species=5, mobility=1e-3,
                 tile=(8, 8), empty=0.1, seed=7)
GOLDEN_N, GOLDEN_MCS, GOLDEN_CHUNK = 4, 6, 3

ALL_OBS = ("densities", "interface_length", "cluster_size", "snapshot")


@pytest.fixture(autouse=True)
def _quiet_flat_form():
    """The flat ``run_trials(params, dom, ...)`` form warns, as in the
    reference; the tests use it on purpose."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        yield


def small_params(**kw):
    base = dict(length=12, height=12, species=3, seed=9)
    base.update(kw)
    return EscgParams(**base)


def _trials(p, dom, n_trials, **kw):
    kw.setdefault("device", "cpu")
    return run_trials(p, dom, n_trials, **kw)


def _jax_trials(kw, dom, n, **run_kw):
    with jax.threefry_partitionable(False):
        return jtrials.run_trials(JaxParams(**kw), dom, n, **run_kw)


def _same(a, b, observables=True):
    np.testing.assert_array_equal(a.survival, b.survival)
    np.testing.assert_array_equal(a.densities, b.densities)
    np.testing.assert_array_equal(a.stasis_mcs, b.stasis_mcs)
    np.testing.assert_array_equal(a.extinction_mcs, b.extinction_mcs)
    assert a.mcs_completed == b.mcs_completed
    assert a.kept_fraction == b.kept_fraction
    if observables:
        assert sorted(a.observables) == sorted(b.observables)
        for name in a.observables:
            np.testing.assert_array_equal(a.observables[name],
                                          b.observables[name])


# ------------------------------ the golden -------------------------------- #

@pytest.mark.parametrize("engine", ["sublattice", "pallas"])
def test_trial_golden_reproduced(engine):
    """``tests/golden/trial_result.json`` (frozen on ``sublattice``) by the
    port's run_trials on the plain sweep and on K3's plain path."""
    with open(TRIAL_GOLDEN) as f:
        want = json.load(f)
    r = _trials(EscgParams(engine=engine, **GOLDEN_KW), dm.RPSLS(),
                GOLDEN_N, n_mcs=GOLDEN_MCS, chunk_mcs=GOLDEN_CHUNK,
                stop_on_stasis=False)
    assert json.loads(r.to_json()) == want


@pytest.mark.parametrize("k_mcs", [1, 3])
def test_fused_trials_equal_per_trial_simulate(k_mcs):
    """The fused family has no trial golden: each trial of the port's
    run_trials on ``pallas_fused`` (K1, or K2 with ``k_mcs`` 3) equals the
    port's ``simulate`` (held to the fused golden elsewhere) from the
    trial's lattice (drawn from ``kg``) and run key ``kr``."""
    p = EscgParams(engine="pallas_fused", k_mcs=k_mcs, mcs=7,
                   chunk_mcs=4, observables=("densities",), **GOLDEN_KW)
    r = _trials(p, dm.RPSLS(), 3, stop_on_stasis=False)
    keys = fold_trial_keys(threefry.PRNGKey(p.seed), 3)
    for t in range(3):
        kg, kr = threefry.split(keys[t])
        g0 = lattice.init_grid(kg, 16, 16, 5, 0.1, device="cpu")
        s = simulate(p, dm.RPSLS(), grid0=g0, key=kr, stop_on_stasis=False,
                     device="cpu")
        np.testing.assert_array_equal(r.densities[t], s.densities[-1])
        np.testing.assert_array_equal(r.observables["densities"][t],
                                      s.densities[1:])
        np.testing.assert_array_equal(r.survival[t],
                                      s.densities[-1, 1:] > 0)


# ------------------------- against the JAX package ------------------------- #

JAX_CASES = [
    # (engine, flux, observables, cell_dtype, obs_capacity)
    ("sublattice", True, (), "int32", 0),
    ("sublattice", True, ALL_OBS, "int8", 0),
    ("batched", True, (), "int32", 0),
    ("batched", True, ("densities", "interface_length"), "int8", 0),
    ("batched", False, (), "int8", 0),
    ("batched", False, ALL_OBS, "int32", 1),
    ("reference", True, (), "int32", 0),
    ("reference", False, ("interface_length", "snapshot"), "int8", 0),
]


@pytest.mark.parametrize("engine,flux,observables,dtype,cap", JAX_CASES)
def test_run_trials_matches_jax(engine, flux, observables, dtype, cap):
    """The whole TrialResult, streams included, equals the JAX package's
    ``trials.run_trials`` (12 x 12, 5 trials, 5 MCS in chunks of 2;
    ``obs_capacity=1`` keeps the reference's lossy ring wraparound)."""
    kw = dict(length=12, height=12, species=3, seed=9, engine=engine,
              flux=flux, observables=observables, cell_dtype=dtype,
              mobility=1e-3, empty=0.1, tile=(4, 4), obs_capacity=cap)
    want = _jax_trials(kw, jdm.RPS(), 5, n_mcs=5, chunk_mcs=2,
                       stop_on_stasis=False)
    got = _trials(EscgParams(**kw), jdm.RPS(), 5, n_mcs=5, chunk_mcs=2,
                  stop_on_stasis=False)
    assert json.loads(got.to_json()) == json.loads(want.to_json())
    if engine == "batched":
        assert got.kept_fraction < 1.0
    if observables:
        assert set(got.observables) == set(("densities",) + observables)


def test_scenario_first_call_matches_jax():
    """``run_trials(scenario, n_trials=..., engine=..., run=...)`` with the
    scenario's declared observables and stasis exit, against the
    reference's same call."""
    with jax.threefry_partitionable(False):
        want = jtrials.run_trials(
            jscenarios.make_scenario("park3"), n_trials=3,
            engine=jscenarios.EngineConfig(engine="batched"),
            run=jscenarios.RunConfig(length=10, height=10, mcs=4,
                                     chunk_mcs=3))
    got = run_trials(make_scenario("park3"), n_trials=3,
                     engine=EngineConfig(engine="batched"),
                     run=RunConfig(length=10, height=10, mcs=4, chunk_mcs=3),
                     device="cpu")
    assert sorted(got.observables) == ["densities", "interface_length"]
    _same(got, convert.trial_result_from_jax(want))


# ----------------------- the chunk and the batch contract ------------------ #

SINGLE_DEVICE = [("reference", 1), ("batched", 1), ("sublattice", 1),
                 ("pallas", 1), ("pallas_fused", 1), ("pallas_fused", 3)]


@pytest.mark.parametrize("engine,k_mcs", SINGLE_DEVICE)
def test_trial_chunk_equals_per_trial_loops(engine, k_mcs):
    """``build_trial_chunk``'s lattices, counts, masks and kept counts
    equal each trial run alone through the single-lattice ``schedule`` and
    ``one_mcs`` (``multi_mcs`` for ``k_mcs`` 3)."""
    p = EscgParams(length=16, height=16, species=5, seed=4, engine=engine,
                   tile=(8, 8), k_mcs=k_mcs, mobility=1e-3,
                   empty=0.1).validate()
    dom = dm.circulant(5, (1, 2))
    built = engines.build(p, dom, "cpu")
    grids, keys = trial_grids_and_keys(p, threefry.PRNGKey(2), 3, "cpu")
    g2, k2, cnts, alive, kept, att = build_trial_chunk(p, built)(
        grids.clone(), keys, 5)
    assert alive.shape == (3, 5, 5) and alive.dtype == torch.bool
    for t in range(3):
        key, words, shifts = built.schedule(keys[t], 5)
        g, kept_t, rows = grids[t], 0, []
        if k_mcs > 1:
            for a, b in ((0, 3), (3, 5)):
                g, c = built.multi_mcs(g, words[a:b], shifts[a:b])
                rows.append(c)
            kept_t = 5 * built.attempts_per_mcs
        else:
            for w, s in zip(words.tolist(), shifts.tolist()):
                g, k = built.one_mcs(g, w, s)
                kept_t += int(k)
                rows.append(built.counts(g, 5)[None])
        rows = torch.cat(rows)
        assert torch.equal(g2[t], g)
        assert torch.equal(k2[t], key)
        assert torch.equal(cnts[t], rows[-1])
        assert torch.equal(alive[t], rows[:, 1:] > 0)
        assert int(kept[t]) == kept_t
        assert int(att[t]) == 5 * built.attempts_per_mcs


@pytest.mark.parametrize("engine", ["reference", "batched", "sublattice",
                                    "pallas", "pallas_fused"])
def test_schedule_batch_equals_stacked_schedule(engine):
    """A few trials and MCS, then 64 trials x 40 MCS, whose 2,560 keys
    reach far more of the key words' values."""
    p = EscgParams(length=16, height=16, species=3, engine=engine,
                   tile=(8, 8)).validate()
    built = engines.build(p, dm.RPS(), "cpu")
    for n_trials, n_mcs in ((4, 6), (64, 40)):
        keys = threefry.split(threefry.PRNGKey(13), n_trials)
        kb, wb, sb = built.schedule_batch(keys, n_mcs)
        for t in range(n_trials):
            k, w, s = built.schedule(keys[t], n_mcs)
            assert torch.equal(kb[t], k)
            assert torch.equal(wb[t], w)
            assert torch.equal(sb[t], s.to(sb.dtype))


def test_batched_draws_equal_single_key_draws():
    """The trial-batched stream, proposal and shift draws equal the
    single-key ones stacked over the keys (``jax.vmap`` of the
    reference's), and so does ``fold_in_batch`` over a batch of keys."""
    keys = threefry.split(threefry.PRNGKey(3), 5)
    ids = torch.arange(9)
    got = rng.tile_stream_batch(keys, ids, 13, 36, 8)
    for t in range(5):
        one = rng.tile_stream_batch(keys[t], ids, 13, 36, 8)
        for a, b in zip(got, one):
            assert torch.equal(a[t], b)
    got = rng.proposal_batch(keys, 11, 100, 4)
    for t in range(5):
        for a, b in zip(got, rng.proposal_batch(keys[t], 11, 100, 4)):
            assert torch.equal(a[t], b)
    for th, tw in ((8, 32), (3, 100_000)):
        got = rng.round_shift(keys, th, tw)
        assert torch.equal(got, torch.stack(
            [rng.round_shift(k, th, tw) for k in keys]).to(got.dtype))
    assert torch.equal(threefry.fold_in_batch(keys, 1), torch.stack(
        [threefry.fold_in(k, 1) for k in keys]))
    with jax.threefry_partitionable(False):
        want = np.asarray(jax.vmap(lambda k: jax.random.fold_in(k, 7))(
            jax.random.split(jax.random.PRNGKey(3), 5)))
    np.testing.assert_array_equal(
        threefry.fold_in_batch(keys, 7).numpy(), want)


def test_vectorised_parts_equal_their_single_lattice_forms():
    """The sweep, the arbitration, the roll, the observables' rows and K4
    over a trial batch equal the single-lattice functions trial by trial;
    the CPU runs the kernels' plain versions and counts no launch."""
    dom = torch.as_tensor(dm.circulant(5, (1, 2)))
    grids = torch.stack([lattice.init_grid(threefry.PRNGKey(s), 16, 24, 5,
                                           0.2, device="cpu")
                         for s in range(3)])
    shifts = torch.tensor([[0, 0], [3, 5], [15, 23]])
    keys = threefry.split(threefry.PRNGKey(8), 3)
    props = rng.tile_stream_batch(keys, torch.arange(6), 40, 36, 4)
    ops.reset_launches()
    got = sublattice.run_round_trials(grids, props, shifts, (8, 8), 0.2,
                                      0.7, dom)
    k3 = escg_update.escg_tile_round_trials(
        grids, *props, dom, torch.as_tensor(lattice.DIRS), (8, 8), 0.2, 0.7,
        shifts)
    k1 = fused.escg_tile_round_fused_trials(
        grids, keys, shifts, dom, torch.as_tensor(lattice.DIRS), (8, 8), 40,
        0.2, 0.7)
    window = rng.proposal_batch(keys, 200, 16 * 24, 8)
    arb, kept = batched.run_proposals_trials(grids, window, 0.2, 0.7, dom,
                                             False)
    for t in range(3):
        shift = tuple(shifts[t].tolist())
        one = [f[t] for f in props]
        want = sublattice.run_round(grids[t], rng.ProposalBatch(*one), shift,
                                    (8, 8), 0.2, 0.7, dom, roll_back=False)
        assert torch.equal(got[t], want)
        assert torch.equal(k3[t], want)
        assert torch.equal(k1[t], fused.escg_tile_round_fused_plain(
            grids[t], tuple(keys[t].tolist()), 0, dom, (8, 8), 40, 0.2, 0.7,
            shift=shift))
        assert torch.equal(sublattice.roll_trials(grids, shifts)[t],
                           torch.roll(grids[t], (-shift[0], -shift[1]),
                                      (0, 1)))
        g, k = batched.run_proposals(
            grids[t], rng.ProposalBatch(*(f[t] for f in window)), 0.2, 0.7,
            dom, False)
        assert torch.equal(arb[t], g) and int(kept[t]) == int(k)
    assert torch.equal(density.density_counts_trials(grids, 5), torch.stack(
        [density.density_counts(g, 5) for g in grids]))
    assert sum(ops.launches().values()) == 0
    p = EscgParams(length=24, height=16, species=5, observables=ALL_OBS)
    pipe = obs.build_pipeline(p)
    cnts = density.density_counts_trials(grids, 5)
    rows = pipe.row(grids, cnts)
    held = pipe.grid_values(grids)
    for t in range(3):
        assert torch.equal(rows[t], pipe.row(grids[t], cnts[t]))
        assert torch.equal(pipe.row_held(cnts[None], held)[0, t],
                           pipe.row_held(cnts[t], pipe.grid_values(grids[t])))


def test_trial_kernels_reject_bad_input():
    dom = torch.as_tensor(dm.RPS())
    dirs = torch.as_tensor(lattice.DIRS)
    grids = torch.zeros((2, 16, 16), dtype=torch.int32)
    good = torch.zeros((2, 2), dtype=torch.int64)
    with pytest.raises(ValueError, match="trial batch"):
        fused.escg_tile_round_fused_trials(grids[0], good, good, dom, dirs,
                                           (8, 8), 4, 0.2, 0.7)
    with pytest.raises(ValueError, match="seeds"):
        fused.escg_tile_round_fused_trials(grids, good[:1], good, dom, dirs,
                                           (8, 8), 4, 0.2, 0.7)
    with pytest.raises(ValueError, match="shifts"):
        fused.escg_tile_rounds_fused_trials(
            grids, torch.zeros((2, 3, 2), dtype=torch.int64), good, dom,
            dirs, (8, 8), 4, 0.2, 0.7, 3)
    with pytest.raises(ValueError, match="trial batch"):
        density.density_counts_trials(torch.zeros(4, dtype=torch.int32), 3)


# --------------------- behaviour (the reference's tests) ------------------- #

def test_run_trials_returns_trial_result():
    r = _trials(small_params(), dm.RPS(), n_trials=5, n_mcs=10)
    assert isinstance(r, TrialResult)
    assert r.survival.shape == (5, 3) and r.survival.dtype == bool
    assert r.densities.shape == (5, 4)
    np.testing.assert_allclose(r.densities.sum(axis=1), 1.0, atol=1e-12)
    assert r.stasis_mcs.shape == (5,) and r.extinction_mcs.shape == (5, 3)
    assert r.mcs_completed == 10 and r.n_trials == 5 and r.n_devices == 1
    assert r.survival.all() and (r.extinction_mcs == -1).all()
    assert 0.0 < r.kept_fraction <= 1.0


def test_trial_prefix_stability():
    p = small_params(species=5, mobility=1e-4)
    r5 = _trials(p, dm.RPSLS(), 5, n_mcs=8, stop_on_stasis=False)
    r3 = _trials(p, dm.RPSLS(), 3, n_mcs=8, stop_on_stasis=False)
    np.testing.assert_array_equal(r3.survival, r5.survival[:3])
    np.testing.assert_array_equal(r3.densities, r5.densities[:3])
    np.testing.assert_array_equal(r3.stasis_mcs, r5.stasis_mcs[:3])
    np.testing.assert_array_equal(r3.extinction_mcs, r5.extinction_mcs[:3])


@pytest.mark.parametrize("engine", ["batched", "sublattice"])
def test_chunking_invariance(engine):
    p = small_params(species=5, mobility=1e-4, engine=engine, tile=(4, 4),
                     observables=("densities", "snapshot"))
    mono = _trials(p, dm.RPSLS(), 4, n_mcs=9, chunk_mcs=9,
                   stop_on_stasis=False)
    chunked = _trials(p, dm.RPSLS(), 4, n_mcs=9, chunk_mcs=2,
                      stop_on_stasis=False)
    _same(mono, chunked)


def test_stasis_early_exit_and_recording():
    """One species and empties: stasis from MCS 1, and the driver stops at
    the first chunk boundary instead of running all 500 MCS."""
    p = EscgParams(length=10, height=10, species=1, mcs=500, chunk_mcs=50,
                   empty=0.5, mu=0.0, sigma=1.0, epsilon=0.0, seed=0)
    r = _trials(p, np.zeros((2, 2), np.float32), n_trials=3)
    assert (r.stasis_mcs == 1).all()
    assert r.mcs_completed == 50


def test_async_stats_schedule_invariance():
    p = small_params(species=5, mobility=1e-4)
    a = _trials(p, dm.RPSLS(), 4, n_mcs=9, chunk_mcs=2, stop_on_stasis=False,
                async_stats=True)
    b = _trials(p, dm.RPSLS(), 4, n_mcs=9, chunk_mcs=2, stop_on_stasis=False,
                async_stats=False)
    _same(a, b)
    assert a.mcs_completed == 9


def test_async_early_exit_drops_speculative_chunk():
    """At a stasis early exit the chunk already enqueued is dropped
    unread: one species keeps filling its empties after stasis, so folding
    that chunk in would change the densities and ``mcs_completed``."""
    p = EscgParams(length=12, height=12, species=1, mcs=40, chunk_mcs=4,
                   empty=0.6, mu=0.0, sigma=0.02, epsilon=1.0, seed=2,
                   observables=("densities",))
    dom = np.zeros((2, 2), np.float32)
    sync = _trials(p, dom, 3, async_stats=False)
    longer = _trials(p.replace(chunk_mcs=8), dom, 3, async_stats=False)
    assert not np.array_equal(longer.densities, sync.densities)
    assert longer.mcs_completed == 8
    r = _trials(p, dom, 3, async_stats=True)
    assert r.mcs_completed == sync.mcs_completed == 4
    _same(r, sync)
    assert (r.stasis_mcs == 1).all()
    assert r.observables["densities"].shape == (3, 4, 2)


def test_cell_dtype_honoured_and_value_stable():
    p8 = small_params(cell_dtype="int8").validate()
    grids, keys = trial_grids_and_keys(p8, threefry.PRNGKey(0), 2, "cpu")
    assert grids.dtype == torch.int8 and keys.shape == (2, 2)
    with jax.threefry_partitionable(False):
        jg, jk = jtrials.trial_grids_and_keys(
            JaxParams(**json.loads(p8.to_json())).validate(),
            jax.random.PRNGKey(0), 2)
    np.testing.assert_array_equal(grids.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(keys.numpy(), np.asarray(jk))
    r8 = _trials(small_params(cell_dtype="int8"), dm.RPS(), 3, n_mcs=6,
                 stop_on_stasis=False)
    r32 = _trials(small_params(), dm.RPS(), 3, n_mcs=6, stop_on_stasis=False)
    _same(r8, r32)


def test_zero_mcs_returns_initial_state():
    r = _trials(small_params(empty=0.0), dm.RPS(), 3, n_mcs=0)
    assert r.mcs_completed == 0 and r.survival.all()
    np.testing.assert_allclose(r.densities.sum(axis=1), 1.0, atol=1e-12)
    assert r.kept_fraction == 1.0
    with pytest.raises(ValueError, match="chunk_mcs"):
        _trials(small_params(), dm.RPS(), 3, n_mcs=5, chunk_mcs=0)
    with pytest.raises(ValueError, match="n_trials"):
        _trials(small_params(), dm.RPS(), 0, n_mcs=5)


def test_padding_helper():
    assert pad_trials(5, 4) == 8
    assert pad_trials(8, 4) == 8
    assert pad_trials(1, 4) == 4
    assert pad_trials(7, 1) == 7


def test_pod_validation():
    with pytest.raises(ValueError, match="trial_devices"):
        pod_devices("cpu", 0)
    with pytest.raises(ValueError, match="devices are available"):
        pod_devices(["cpu"] * 2, 3)
    assert pod_devices(["cpu"] * 3, 2) == (torch.device("cpu"),) * 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run_trials(small_params(), dm.RPS(), 2, n_mcs=1)


def test_rejects_the_decomposed_engines():
    with pytest.raises(ValueError, match="vmappable"):
        _trials(EscgParams(length=16, height=16, engine="sharded",
                           tile=(8, 8)), dm.RPS(), n_trials=2, n_mcs=1)
    # the composed engine owns its mesh: its pod width is mesh_shape's
    with pytest.raises(ValueError, match="not trial_devices"):
        run_trials(make_scenario("park3"), n_trials=2,
                   engine=EngineConfig(engine="sharded_pod", tile=(8, 8)),
                   run=RunConfig(length=16, height=16, mcs=1),
                   device="cpu", trial_devices=1)
    caps = engines.get_engine("sharded").caps
    assert not caps.vmappable and not caps.trial_shardable
    assert not caps.pod_composable
    caps = engines.get_engine("sharded_pod").caps
    assert not caps.vmappable and not caps.trial_shardable
    assert caps.pod_composable
    for name in ("reference", "batched", "sublattice", "pallas",
                 "pallas_fused"):
        caps = engines.get_engine(name).caps
        assert caps.vmappable and caps.trial_shardable


def test_hooks_stream_per_chunk():
    calls = []
    _trials(small_params(), dm.RPS(), 4, n_mcs=9, chunk_mcs=3,
            stop_on_stasis=False,
            hooks=[lambda m, alive: calls.append((m, alive.shape))])
    assert calls == [(3, (4,)), (6, (4,)), (9, (4,))]


def test_trial_chunk_shapes():
    p = small_params().validate()
    built = engines.build(p, dm.RPS(), "cpu")
    grids, keys = trial_grids_and_keys(p, threefry.PRNGKey(1), 4, "cpu")
    g2, k2, cnts, alive, kept, att = build_trial_chunk(p, built)(
        grids, keys, 5)
    assert g2.shape == (4, 12, 12) and k2.shape == (4, 2)
    assert cnts.shape == (4, 4)
    assert alive.shape == (4, 5, 3) and alive.dtype == torch.bool
    assert kept.shape == (4,) and att.shape == (4,)
    assert int(cnts.sum()) == 4 * p.n_cells
    with pytest.raises(ValueError, match="at least one MCS"):
        build_trial_chunk(p, built)(grids, keys, 0)


def test_trial_result_statistics_roundtrip():
    surv = np.array([[True, True, False], [True, False, False],
                     [True, True, True], [True, False, False]])
    res = TrialResult(
        survival=surv, densities=np.array([[0.0, 0.5, 0.5, 0.0]] * 4),
        stasis_mcs=np.array([3, -1, 7, 2]),
        extinction_mcs=np.array([[-1, -1, 4]] * 4),
        mcs_completed=10, kept_fraction=0.9, n_trials=4, n_devices=2,
        observables={"densities": np.ones((4, 2, 4))})
    np.testing.assert_allclose(res.survival_probabilities(),
                               [1.0, 0.5, 0.25])
    np.testing.assert_allclose(res.survivors_hist(), [0.0, 0.5, 0.25, 0.25])
    assert res.extinction_probability(3) == 0.75 and res.species == 3
    back = TrialResult.from_json(res.to_json())
    assert back.to_json() == res.to_json()
    assert back.survival.dtype == bool
    jres = jtrials.TrialResult.from_json(res.to_json())
    assert convert.trial_result_from_jax(jres).to_json() == res.to_json()


def test_legacy_wrapper_returns_survival_mask():
    surv = legacy_run_trials(small_params(), dm.RPS(), 5, n_mcs=10,
                             device="cpu")
    assert isinstance(surv, np.ndarray)
    assert surv.shape == (5, 3) and surv.dtype == bool
    with jax.threefry_partitionable(False):
        from repro.core import run_trials as jlegacy
        want = jlegacy(JaxParams(length=12, height=12, species=3, seed=9),
                       jdm.RPS(), 5, n_mcs=10)
    np.testing.assert_array_equal(surv, want)


def test_flat_form_warns_and_engine_spellings():
    with pytest.warns(DeprecationWarning, match="Scenario first"):
        run_trials(small_params(), dm.RPS(), 2, n_mcs=1, device="cpu")
    with pytest.raises(TypeError, match="engine="):
        run_trials(make_scenario("park3"), n_trials=2,
                   engine=EngineConfig(), engine_config=EngineConfig(),
                   device="cpu")


# ------------------------------- the pod axis ------------------------------ #

@pytest.mark.parametrize("engine,k_mcs", [("batched", 1),
                                          ("pallas_fused", 1),
                                          ("pallas_fused", 2)])
def test_pod_layouts_bit_identical(engine, k_mcs):
    """``device=["cpu"] * k`` for k = 1, 2, 3 (5 trials pad to 6), and
    ``trial_devices`` cutting a longer pod, give one result."""
    p = EscgParams(length=16, height=16, species=5, mobility=1e-4, seed=3,
                   cell_dtype="int8", engine=engine, tile=(8, 8),
                   k_mcs=k_mcs, observables=("densities", "cluster_size"))
    rs = {k: _trials(p, dm.RPSLS(), 5, n_mcs=5, chunk_mcs=3,
                     stop_on_stasis=False, device=["cpu"] * k)
          for k in (1, 2, 3)}
    for k in (2, 3):
        assert rs[k].n_devices == k
        _same(rs[k], rs[1])
    cut = _trials(p, dm.RPSLS(), 5, n_mcs=5, chunk_mcs=3,
                  stop_on_stasis=False, device=["cpu"] * 4, trial_devices=2)
    assert cut.n_devices == 2
    _same(cut, rs[1])


# ------------------------- presets and Table 4.2 --------------------------- #

@pytest.mark.parametrize("name,kw", [
    ("zhong_density", {}), ("probabilistic", {}),
    ("probabilistic", dict(alpha=0.3, beta=0.5, mobility=1e-3)),
    ("asym_rps", dict(r23=0.5)), ("park3", {}), ("nspecies7", {})])
def test_presets_match_the_reference(name, kw):
    sc = make_scenario(name, **kw)
    jsc = jscenarios.make_scenario(name, **kw)
    assert json.loads(sc.to_json()) == json.loads(jsc.to_json())
    np.testing.assert_array_equal(sc.dominance(), jsc.dominance())
    assert scenarios.scenario_key(sc) == jscenarios.scenario_key(jsc)
    assert scenarios.scenario_observables(name) == \
        jscenarios.scenario_observables(name)
    p = scenarios.compose(sc, EngineConfig(), RunConfig(length=20, height=20))
    assert scenarios.compose(*scenarios.decompose(p, name)) == p
    jp = jscenarios.compose(jsc, jscenarios.EngineConfig(),
                            jscenarios.RunConfig(length=20, height=20))
    assert json.loads(p.to_json()) == json.loads(jp.to_json())


def test_park_table_4_2_matches_the_reference():
    """``species5_extinction_std`` on a tiny case with extinctions (6 x 6
    and 8 x 8, 6 trials, 0, 10 and 40 MCS) and ``survival_probabilities``
    equal the reference's."""
    with jax.threefry_partitionable(False):
        want = jpark.species5_extinction_std([6, 8], [0, 10, 40],
                                             n_trials=6, seed=2)
        jprob = jpark.survival_probabilities(0.15, 0.75, L=6, n_trials=4,
                                             mcs=30,
                                             key=jax.random.PRNGKey(3))
    got = park.species5_extinction_std([6, 8], [0, 10, 40], n_trials=6,
                                       seed=2, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert got.max() > 0
    prob = park.survival_probabilities(0.15, 0.75, L=6, n_trials=4, mcs=30,
                                       key=threefry.PRNGKey(3), device="cpu")
    for a, b in zip(prob, jprob):
        np.testing.assert_array_equal(a, b)
    p = park.park_params(L=10, mcs=7, seed=1)
    assert (p.species, p.length, p.mcs, p.eps) == (8, 10, 7, 0.0)
    jp = jpark.park_params(L=10, mcs=7, seed=1)
    assert json.loads(p.to_json()) == json.loads(jp.to_json())


def test_make_trial_init_is_simulate_with_kg_and_kr():
    """A trial's lattice is drawn from ``kg`` and its chain keyed by
    ``kr`` (not ``simulate(key=fold_in(key, t))``)."""
    p = small_params(engine="batched", mcs=3, chunk_mcs=3).validate()
    keys = fold_trial_keys(threefry.PRNGKey(p.seed), 2)
    grids, run_keys = make_trial_init(p, "cpu")(keys)
    r = _trials(p, dm.RPS(), 2, stop_on_stasis=False)
    for t in range(2):
        kg, kr = threefry.split(keys[t])
        assert torch.equal(run_keys[t], kr)
        s = simulate(p, dm.RPS(), grid0=grids[t], key=kr,
                     stop_on_stasis=False, device="cpu")
        np.testing.assert_array_equal(r.densities[t], s.densities[-1])
