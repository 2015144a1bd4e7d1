"""The port's main path — ``simulate`` on the ``pallas_fused`` engine —
against the JAX package, and the state carried between the two.

The JAX-side run is built from the reference's plain pieces (its Pallas
update kernels do not run on the installed JAX): the MCS loop's ``split``
chain, ``engines.fused_round_inputs``, ``ref.fused_proposals_ref`` and
``sublattice.run_round(roll_back=False)``. Integers must match exactly,
and densities are float64 of integer counts, so they match exactly too.
"""
import hashlib
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import EscgParams as JaxParams
from repro.core import engines as jengines
from repro.core import lattice as jlattice
from repro.core import scenarios as jscenarios
from repro.core import sublattice as jsublattice
from repro.core.rng import ProposalBatch
from repro.kernels import ref
from repro_torch import convert
from repro_torch.core import engines, threefry
from repro_torch.core.params import EscgParams
from repro_torch.core.scenarios import (EngineConfig, RunConfig, Scenario,
                                        compose, make_scenario)
from repro_torch.core.simulation import SimResult, simulate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FUSED_GOLDEN = os.path.join(REPO, "tests", "golden", "fused_trajectory.json")


def _grid_hash(grid) -> str:
    """The goldens' digest: little-endian int32 raster bytes."""
    return hashlib.sha256(np.ascontiguousarray(
        np.asarray(grid).astype("<i4")).tobytes()).hexdigest()


def _jax_reference_run(p: EscgParams, dom: np.ndarray):
    """(final grid, densities) of the reference's plain fused path."""
    th, tw = p.tile
    n_tiles = (p.height // th) * (p.length // tw)
    k = -(-p.n_cells // n_tiles)
    te, tem = p.action_thresholds()
    with jax.threefry_partitionable(False):
        key = jax.random.PRNGKey(p.seed)
        key, k0 = jax.random.split(key)
        grid = jlattice.init_grid(k0, p.height, p.length, p.species,
                                  p.empty, dtype=jnp.dtype(p.cell_dtype))
        hist = [np.asarray(jlattice.counts(grid, p.species))]
        for _ in range(p.mcs):
            key, k1 = jax.random.split(key)
            seed, shift = jengines.fused_round_inputs(k1, th, tw)
            props = ProposalBatch(*(jnp.asarray(a) for a in
                                    ref.fused_proposals_ref(
                                        n_tiles, k, (th - 2) * (tw - 2),
                                        p.neighbourhood, np.asarray(seed),
                                        0)))
            grid = jsublattice.run_round(grid, props, shift, (th, tw), te,
                                         tem, jnp.asarray(dom),
                                         roll_back=False)
            hist.append(np.asarray(jlattice.counts(grid, p.species)))
    return np.asarray(grid), np.stack(hist) / p.n_cells


_REF_CACHE = {}


def _reference(species, dtype, mcs):
    key = (species, dtype, mcs)
    if key not in _REF_CACHE:
        sc = make_scenario(f"nspecies{species}", mobility=2e-3, empty=0.1)
        p = EscgParams(length=32, height=16, species=species, mcs=mcs,
                       mobility=2e-3, empty=0.1, engine="pallas_fused",
                       tile=(8, 16), cell_dtype=dtype, seed=3)
        _REF_CACHE[key] = (sc, _jax_reference_run(p, sc.dominance()))
    return _REF_CACHE[key]


@pytest.mark.parametrize("species", [3, 5])
@pytest.mark.parametrize("dtype", ["int8", "int32"])
@pytest.mark.parametrize("k_mcs,chunk_mcs", [(1, 3), (2, 3), (3, 4)])
def test_simulate_matches_jax_reference(species, dtype, k_mcs, chunk_mcs):
    """Chunks of 3 and 4 split the K-groups of k_mcs 2 and 3, so the
    remainder launches and the chunk-boundary key hand-over are covered."""
    sc, (want_grid, want_dens) = _reference(species, dtype, 7)
    res = simulate(sc, engine=EngineConfig(engine="pallas_fused",
                                           tile=(8, 16), cell_dtype=dtype,
                                           k_mcs=k_mcs),
                   run=RunConfig(length=32, height=16, mcs=7,
                                 chunk_mcs=chunk_mcs, seed=3,
                                 observables=()),
                   stop_on_stasis=False, device="cpu")
    assert res.grid.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(res.grid, want_grid)
    np.testing.assert_array_equal(res.densities, want_dens)
    assert res.mcs_completed == 7 and res.kept_fraction == 1.0


def _golden_run(device, k_mcs=1):
    """The fused golden's config (16x16 RPSLS, seed 11) as a scenario:
    ``nspecies5`` is C(5, {1, 2}), the RPSLS network the golden used."""
    hashes = []
    res = simulate(make_scenario("nspecies5", mobility=1e-3, empty=0.1),
                   engine=EngineConfig(engine="pallas_fused", tile=(8, 8),
                                       k_mcs=k_mcs),
                   run=RunConfig(length=16, height=16, mcs=5, chunk_mcs=1,
                                 seed=11, observables=()),
                   stop_on_stasis=False, device=device,
                   hooks=[lambda mcs, grid, cnts:
                          hashes.append(_grid_hash(grid.cpu().numpy()))])
    return hashes, res


def test_fused_golden_reproduced_by_plain_path():
    with open(FUSED_GOLDEN) as f:
        want = json.load(f)
    hashes, res = _golden_run("cpu")
    assert hashes == want["grid_hashes"]
    assert _grid_hash(res.grid) == want["final_hash"]
    np.testing.assert_array_equal(res.densities,
                                  np.asarray(want["densities"]))
    assert res.kept_fraction == want["kept_fraction"]


def test_stasis_stops_at_the_chunk_boundary():
    """One species is stasis from the first MCS: ``stasis_mcs`` is exact,
    the run stops at the end of that chunk."""
    res = simulate(Scenario(species=1), np.zeros((2, 2), np.float32),
                   engine=EngineConfig(engine="pallas_fused", tile=(8, 8)),
                   run=RunConfig(length=16, height=16, mcs=20, chunk_mcs=4),
                   device="cpu")
    assert res.stasis_mcs == 1 and res.mcs_completed == 4
    assert res.densities.shape == (5, 2)


def test_no_device_means_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        simulate(make_scenario("park3"),
                 engine=EngineConfig(engine="pallas_fused", tile=(8, 8)),
                 run=RunConfig(length=16, height=16, mcs=1,
                               observables=()))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engines.build(EscgParams(engine="pallas_fused", tile=(8, 8),
                                 length=16, height=16))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.grid_from_jax(np.zeros((8, 8), np.int32))


@pytest.mark.parametrize("engine", ["sharded_pod"])
def test_unported_engines_are_refused(engine):
    """No engine of the reference is refused any more: ``NOT_PORTED`` is
    empty, and ``sharded_pod``, the last one ported, runs ``simulate`` as
    ``sharded`` on its pod group 0's grid."""
    assert not engines.NOT_PORTED
    assert engine in engines.engine_names()

    def run(**kw):
        return simulate(make_scenario("park3"),
                        engine=EngineConfig(tile=(8, 8), **kw),
                        run=RunConfig(length=16, height=16, mcs=2,
                                      observables=()),
                        device=["cpu"] * 4, stop_on_stasis=False)
    got = run(engine=engine, mesh_shape=(2, 1, 2))
    want = run(engine="sharded", shard_grid=(1, 2))
    np.testing.assert_array_equal(got.grid, want.grid)
    np.testing.assert_array_equal(got.densities, want.densities)


# ------------------------------- convert --------------------------------- #

def test_convert_params_round_trip():
    jp = JaxParams(length=48, height=24, species=5, engine="pallas_fused",
                   tile=(8, 16), k_mcs=3, cell_dtype="int8", seed=9,
                   observables=("densities",), mobility=1e-3)
    p = convert.config_from_jax(jp)
    assert isinstance(p, EscgParams)
    assert json.loads(p.to_json()) == json.loads(jp.to_json())
    assert JaxParams.from_json(p.to_json()) == jp
    assert convert.config_from_jax(jp.to_json(), "EscgParams") == p


def test_convert_scenario_triple_round_trip():
    jsc = jscenarios.make_scenario("nspecies5", mobility=1e-3, empty=0.1)
    jeng = jscenarios.EngineConfig(engine="pallas_fused", tile=(8, 8),
                                   k_mcs=2)
    jrun = jscenarios.RunConfig(length=16, height=16, mcs=5, chunk_mcs=2,
                                observables=())
    sc, eng, run = (convert.config_from_jax(o) for o in (jsc, jeng, jrun))
    assert isinstance(sc, Scenario)
    for port, ref_obj in ((sc, jsc), (eng, jeng), (run, jrun)):
        assert json.loads(port.to_json()) == json.loads(ref_obj.to_json())
        assert type(ref_obj).from_json(port.to_json()) == ref_obj
    np.testing.assert_array_equal(sc.dominance(), jsc.dominance())
    assert json.loads(compose(sc, eng, run).to_json()) == \
        json.loads(jscenarios.compose(jsc, jeng, jrun).to_json())


def test_convert_state_round_trip():
    with jax.threefry_partitionable(False):
        jkey = jax.random.split(jax.random.PRNGKey(17))[1]
        grid = np.asarray(jlattice.init_grid(jkey, 16, 32, 4, 0.2,
                                             dtype=jnp.int16))
        data = np.asarray(jax.random.key_data(jkey))
        split = np.asarray(jax.random.split(jkey))
    key = convert.key_from_jax(data)
    np.testing.assert_array_equal(convert.key_to_numpy(key), data)
    np.testing.assert_array_equal(threefry.split(key).numpy(), split)
    g = convert.grid_from_jax(grid, device="cpu")
    assert g.dtype == torch.int16
    np.testing.assert_array_equal(g.numpy(), grid)
    dom = convert.dom_from_jax(make_scenario("nspecies5").dominance(),
                               device="cpu")
    assert dom.dtype == torch.float32 and dom.shape == (6, 6)


def test_simulate_from_carried_state_matches_jax_reference():
    """A JAX-side config, key and lattice carried across run to the same
    trajectory as the reference's plain fused path from that state."""
    p = EscgParams(length=32, height=16, species=3, mcs=4, mobility=2e-3,
                   engine="pallas_fused", tile=(8, 16), seed=3,
                   empty=0.1)
    dom = make_scenario("nspecies3").dominance()
    want_grid, want_dens = _jax_reference_run(p, dom)
    with jax.threefry_partitionable(False):
        key, k0 = jax.random.split(jax.random.PRNGKey(3))
        grid0 = np.asarray(jlattice.init_grid(k0, 16, 32, 3, 0.1))
    res = simulate(convert.config_from_jax(p.to_json(), "EscgParams"),
                   convert.dom_from_jax(dom, "cpu").numpy(),
                   grid0=convert.grid_from_jax(grid0, "cpu"),
                   key=convert.key_from_jax(np.asarray(key)),
                   stop_on_stasis=False, device="cpu")
    np.testing.assert_array_equal(res.grid, want_grid)
    np.testing.assert_array_equal(res.densities, want_dens)


def test_sim_result_json_round_trip():
    _, res = _golden_run("cpu")
    back = SimResult.from_json(res.to_json())
    np.testing.assert_array_equal(back.grid, res.grid)
    np.testing.assert_array_equal(back.densities, res.densities)
    assert (back.mcs_completed, back.stasis_mcs, back.kept_fraction) == \
        (res.mcs_completed, res.stasis_mcs, res.kept_fraction)


def test_port_imports_no_jax():
    code = ("import sys\n"
            "import repro_torch.core.simulation, repro_torch.convert\n"
            "import repro_torch.kernels.ops, repro_torch.kernels.build\n"
            "import repro_torch.core.observables, repro_torch.core.rng\n"
            "import repro_torch.core.sublattice, repro_torch.perf_probe\n"
            "import repro_torch.kernels.escg_update\n"
            "import repro_torch.kernels.density\n"
            "import repro_torch.kernels.philox\n"
            "import repro_torch.kernels.reference_scan\n"
            "import repro_torch.core.batched, repro_torch.core.reference\n"
            "import repro_torch.core.sharded\n"
            "import repro_torch.core.trials, repro_torch.core.park\n"
            "import repro_torch.parallel.sharding\n"
            "import repro_torch.launch.escg_run, repro_torch.launch.serve\n"
            "import repro_torch.serve.server\n"
            "import repro_torch.configs, repro_torch.models.registry\n"
            "import repro_torch.models.transformer\n"
            "import repro_torch.optim.compression, repro_torch.data\n"
            "import repro_torch.runtime.checkpoint\n"
            "import repro_torch.runtime.fault\n"
            "import repro_torch.runtime.train_lib\n"
            "import repro_torch.launch.train\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'repro.')) or m == 'repro')\n"
            "print(bad)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
