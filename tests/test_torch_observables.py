"""The port's observable pipeline against the JAX package: every
observable's ``compute``, the row layout, the device ring, and the
``pallas_fused`` chunk with observables at ``k_mcs`` 1 and 3 (the
lag-hold rows included) against the reference's ``build_obs_chunk_fn``.

The reference's ``pallas_fused`` engine reaches a Pallas kernel that does
not run on the installed JAX, so its chunk is driven here with a built
engine of the reference's plain pieces: ``philox.philox_proposal_fields``
(the fused kernels' counter layout, in jnp), ``engines.fused_round_inputs``
/ ``multi_round_inputs`` and ``sublattice.run_round``. Comparisons are
exact; float32 rows hold integers below 2**24.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engines as jengines
from repro.core import lattice as jlattice
from repro.core import metrics as jmetrics
from repro.core import observables as jobs
from repro.core import scenarios as jscenarios
from repro.core import sublattice as jsublattice
from repro.core.rng import ProposalBatch
from repro.core.simulation import build_obs_chunk_fn
from repro.kernels import philox as jphilox
from repro_torch.core import lattice, results, threefry
from repro_torch.core import observables as obs
from repro_torch.core.scenarios import (EngineConfig, RunConfig, compose,
                                        make_scenario)
from repro_torch.core.simulation import simulate

ALL_OBS = ("densities", "interface_length", "cluster_size", "snapshot")


def _params(h, w, species, observables=ALL_OBS):
    """Params of an (h, w) lattice; one tile covers it, so any size
    validates."""
    return compose(make_scenario(f"nspecies{species}"),
                   EngineConfig(engine="pallas_fused", tile=(h, w)),
                   RunConfig(length=w, height=h, observables=observables))


def _grid(h, w, species, dtype, seed):
    return np.random.RandomState(seed).randint(
        0, species + 1, size=(h, w)).astype(dtype)


# ------------------------------ registry --------------------------------- #

def test_registry_matches_reference():
    assert obs.observable_names() == jobs.observable_names()
    assert results.STREAM_NAMES == jobs.observable_names()
    for s, js in zip(obs.observable_specs(), jobs.observable_specs()):
        assert (s.name, s.from_counts) == (js.name, js.from_counts)
    with pytest.raises(ValueError, match="unknown observable"):
        obs.resolve(["densities", "nope"])
    assert [s.name for s in obs.resolve(["snapshot", "densities",
                                         "snapshot"])] == ["densities",
                                                           "snapshot"]


def test_stream_names_read_the_registry():
    obs.register_observable("probe_total", width=lambda p: 1)(
        lambda grid, counts, p: grid.sum().reshape(1))
    try:
        assert "probe_total" in results.STREAM_NAMES
    finally:
        del obs._REGISTRY["probe_total"]
    assert "probe_total" not in results.STREAM_NAMES


# ------------------------------- compute --------------------------------- #

@pytest.mark.parametrize("name", ALL_OBS)
@pytest.mark.parametrize("hw,species,dtype", [
    ((16, 32), 3, "int32"), ((24, 16), 5, "int8"), ((9, 15), 3, "int16")])
def test_compute_matches_reference(name, hw, species, dtype):
    grid = _grid(*hw, species, dtype, seed=hw[0] + species)
    p = _params(*hw, species)
    counts = np.bincount(grid.ravel().astype(np.int64),
                         minlength=species + 1).astype(np.int32)
    want = jobs.get_observable(name).compute(jnp.asarray(grid),
                                             jnp.asarray(counts), p)
    got = obs.get_observable(name).compute(torch.from_numpy(grid),
                                           torch.from_numpy(counts), p)
    np.testing.assert_array_equal(
        got.to(torch.float32).reshape(-1).numpy(),
        np.asarray(want, np.float32).reshape(-1))


def test_snapshot_ties_take_the_first_maximum():
    """2 x 2 blocks with two labels twice each: both take the smaller."""
    grid = np.zeros((16, 16), np.int32)
    grid[0::2, :] = 2
    grid[1::2, :] = 1           # every block holds 1, 1, 2, 2
    grid[:2, :2] = [[3, 0], [0, 3]]   # block (0, 0): 0 and 3 tie
    p = _params(16, 16, 3)
    want = np.asarray(jobs.get_observable("snapshot").compute(
        jnp.asarray(grid), None, p))
    got = obs.get_observable("snapshot").compute(torch.from_numpy(grid),
                                                  None, p).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0] == 0 and (got[1:] == 1).all()


def test_pipeline_rows_match_reference():
    p = _params(16, 32, 5, observables=("snapshot", "cluster_size"))
    pipe, jpipe = obs.build_pipeline(p), jobs.build_pipeline(p)
    assert (pipe.widths, pipe.offsets, pipe.width) == \
        (jpipe.widths, jpipe.offsets, jpipe.width)
    assert [s.name for s in pipe.specs] == [s.name for s in jpipe.specs]
    grid = _grid(16, 32, 5, "int32", seed=2)
    counts = np.bincount(grid.ravel(), minlength=6).astype(np.int32)
    row = pipe.row(torch.from_numpy(grid), torch.from_numpy(counts))
    np.testing.assert_array_equal(
        row.numpy(), np.asarray(jpipe.row(jnp.asarray(grid),
                                          jnp.asarray(counts))))
    held = pipe.grid_values(torch.from_numpy(grid))
    jheld = jpipe.grid_values(jnp.asarray(grid))
    assert held.keys() == jheld.keys()
    stack = np.stack([counts, counts[::-1], counts])
    rows = pipe.row_held(torch.from_numpy(stack), held).numpy()
    want = np.stack([np.asarray(jpipe.row_held(jnp.asarray(c), jheld))
                     for c in stack])
    np.testing.assert_array_equal(rows, want)
    np.testing.assert_array_equal(
        pipe.counts_from_rows(rows, 5), jpipe.counts_from_rows(want, 5))
    got, ref = pipe.split(rows), jpipe.split(want)
    assert got.keys() == ref.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], ref[k])


# -------------------------------- ring ----------------------------------- #

@pytest.mark.parametrize("cap,n,per_push", [(3, 7, 1), (4, 10, 3),
                                            (5, 5, 5), (2, 9, 4),
                                            (6, 14, 4), (4, 11, 6),
                                            (5, 13, 7)])
def test_ring_matches_reference_with_wraparound(cap, n, per_push):
    """Pushes of ``per_push`` rows at a time past the capacity leave the
    same ring, and ``ring_flush`` unrolls (and drops) the same rows: among
    them pushes that start mid-ring and wrap, and pushes longer than the
    capacity from a position that is not a multiple of it."""
    rows = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    ring, pos = obs.ring_init(cap, (2,), "cpu")
    jring, jpos = jobs.ring_init(cap, (2,))
    for start in range(0, n, per_push):
        chunk = rows[start:start + per_push]
        if per_push == 1:
            ring, pos = obs.ring_push(ring, pos, torch.from_numpy(chunk[0]))
            jring, jpos = jobs.ring_push(jring, jpos, jnp.asarray(chunk[0]))
        else:
            ring, pos = obs.ring_push_many(ring, pos,
                                           torch.from_numpy(chunk))
            jring, jpos = jobs.ring_push_many(jring, jpos,
                                              jnp.asarray(chunk))
    assert pos == int(jpos) == n
    np.testing.assert_array_equal(ring.numpy(), np.asarray(jring))
    for start in (0, max(0, n - cap), n - 1):
        np.testing.assert_array_equal(
            obs.ring_flush(ring.numpy(), start, n),
            jobs.ring_flush(np.asarray(jring), start, n))
    with pytest.raises(ValueError, match="stop"):
        obs.ring_flush(ring.numpy(), 3, 2)


def test_ring_capacity_is_checked_against_the_chunk():
    with pytest.raises(ValueError, match="ring capacity"):
        obs.ring_init(0, (2,), "cpu")
    with pytest.raises(ValueError, match="obs_capacity"):
        simulate(make_scenario("park3"),
                 engine=EngineConfig(engine="pallas", tile=(8, 8)),
                 run=RunConfig(length=16, height=16, mcs=6, chunk_mcs=4,
                               obs_capacity=3), device="cpu")
    res = simulate(make_scenario("park3"),
                   engine=EngineConfig(engine="pallas", tile=(8, 8)),
                   run=RunConfig(length=16, height=16, mcs=6, chunk_mcs=4,
                                 obs_capacity=9), device="cpu",
                   stop_on_stasis=False)
    assert res.observables["interface_length"].shape == (6, 1)


# ------------------- pallas_fused with observables ----------------------- #

def _jax_plain_fused(p, dom):
    """A reference ``BuiltEngine`` for ``pallas_fused`` from its plain
    pieces (K1/K2's oracle), with the same ``one_mcs``/``multi_mcs``
    contract as the registered one."""
    th, tw = p.tile
    n_tiles = (p.height // th) * (p.length // tw)
    k = -(-p.n_cells // n_tiles)
    te, tem = p.action_thresholds()
    idx = jnp.arange(n_tiles * k, dtype=jnp.uint32)
    att = jnp.int32(n_tiles * k)

    def round_(grid, seed, shift):
        fields = jphilox.philox_proposal_fields(
            idx, 0, seed[0], seed[1], (th - 2) * (tw - 2), p.neighbourhood)
        props = ProposalBatch(*(f.reshape(n_tiles, k) for f in fields))
        return jsublattice.run_round(grid, props, shift, (th, tw), te, tem,
                                     dom, roll_back=False)

    def one_mcs(grid, key):
        seed, shift = jengines.fused_round_inputs(key, th, tw)
        return round_(grid, seed, shift), att, att

    def multi_mcs(grid, key, k_steps):
        key, seeds, shifts = jengines.multi_round_inputs(key, th, tw,
                                                         k_steps)
        cnts = []
        for t in range(k_steps):
            grid = round_(grid, seeds[t], shifts[t])
            cnts.append(jmetrics.counts(grid, p.species))
        return grid, key, jnp.stack(cnts), att * k_steps, att * k_steps

    return jengines.BuiltEngine(one_mcs, multi_mcs=multi_mcs)


def _jax_fused_obs_run(species, dtype, k_mcs, mcs, chunk):
    """The reference ``simulate``'s observable loop over
    ``build_obs_chunk_fn``: (final grid, flushed rows (mcs, width))."""
    jsc = jscenarios.make_scenario(f"nspecies{species}", mobility=2e-3,
                                   empty=0.1)
    p = jscenarios.compose(
        jsc, jscenarios.EngineConfig(engine="pallas_fused", tile=(8, 16),
                                     cell_dtype=dtype, k_mcs=k_mcs),
        jscenarios.RunConfig(length=32, height=16, mcs=mcs,
                             chunk_mcs=chunk, seed=5,
                             observables=ALL_OBS))
    dom = jnp.asarray(jsc.dominance())
    with jax.threefry_partitionable(False):
        chunk_fn, pipe = build_obs_chunk_fn(p, dom,
                                            built=_jax_plain_fused(p, dom))
        key, k0 = jax.random.split(jax.random.PRNGKey(5))
        grid = jlattice.init_grid(k0, 16, 32, species, 0.1,
                                  dtype=jnp.dtype(dtype))
        ring, pos = jobs.ring_init(chunk, (pipe.width,))
        rows, done = [], 0
        while done < mcs:
            n = min(chunk, mcs - done)
            grid, key, ring, pos, _, _ = chunk_fn(grid, key, ring, pos, n)
            rows.append(jobs.ring_flush(np.asarray(ring), done, done + n))
            done += n
    return np.asarray(grid), pipe.split(np.concatenate(rows))


@pytest.mark.parametrize("k_mcs", [1, 3])
@pytest.mark.parametrize("species,dtype", [(3, "int32"), (5, "int8")])
def test_fused_observables_match_reference_chunk(k_mcs, species, dtype):
    """Chunks of 4 split the K-groups of 3, so a lag-held row follows a
    chunk boundary and a remainder launch."""
    want_grid, want = _jax_fused_obs_run(species, dtype, k_mcs, 7, 4)
    res = simulate(make_scenario(f"nspecies{species}", mobility=2e-3,
                                 empty=0.1),
                   engine=EngineConfig(engine="pallas_fused", tile=(8, 16),
                                       cell_dtype=dtype, k_mcs=k_mcs),
                   run=RunConfig(length=32, height=16, mcs=7, chunk_mcs=4,
                                 seed=5, observables=ALL_OBS),
                   stop_on_stasis=False, device="cpu")
    np.testing.assert_array_equal(res.grid, want_grid)
    for name in ALL_OBS:
        got = res.observables[name]
        if name == "densities":     # simulate keeps the initial row
            got = got[1:]
        np.testing.assert_array_equal(got, want[name], err_msg=name)


def test_lag_hold_rows():
    """At k_mcs=3 the count-derived columns equal k_mcs=1 row for row; the
    grid-derived ones repeat k_mcs=1's value at the group's start (the
    initial lattice for the first group)."""
    def run(k_mcs):
        return simulate(make_scenario("nspecies3", mobility=2e-3,
                                      empty=0.1),
                        engine=EngineConfig(engine="pallas_fused",
                                            tile=(8, 16), k_mcs=k_mcs),
                        run=RunConfig(length=32, height=16, mcs=7,
                                      chunk_mcs=7, seed=6,
                                      observables=ALL_OBS),
                        stop_on_stasis=False, device="cpu")
    one, three = run(1), run(3)
    np.testing.assert_array_equal(three.grid, one.grid)
    np.testing.assert_array_equal(three.densities, one.densities)
    p = _params(16, 32, 3)
    _, k0 = threefry.split(threefry.PRNGKey(6))
    g0 = lattice.init_grid(k0, 16, 32, 3, 0.1, device="cpu")
    for name in ("interface_length", "cluster_size", "snapshot"):
        spec = obs.get_observable(name)
        first = spec.post(spec.compute(g0, None, p)
                          .to(torch.float64).numpy()[None], p)[0]
        starts = [first, one.observables[name][2], one.observables[name][5]]
        want = np.stack([starts[t // 3] for t in range(7)])
        np.testing.assert_array_equal(three.observables[name], want,
                                      err_msg=name)


@pytest.mark.parametrize("engine,k_mcs", [("pallas", 1), ("sublattice", 1),
                                          ("pallas_fused", 1),
                                          ("pallas_fused", 2)])
def test_observables_on_and_off_give_one_trajectory(engine, k_mcs):
    def run(observables):
        return simulate(make_scenario("park3"),
                        engine=EngineConfig(engine=engine, tile=(8, 8),
                                            k_mcs=k_mcs),
                        run=RunConfig(length=16, height=24, mcs=5,
                                      chunk_mcs=2, observables=observables),
                        stop_on_stasis=False, device="cpu")
    on, off = run(ALL_OBS), run(())
    np.testing.assert_array_equal(on.grid, off.grid)
    np.testing.assert_array_equal(on.densities, off.densities)
    assert set(on.observables) == set(ALL_OBS)
