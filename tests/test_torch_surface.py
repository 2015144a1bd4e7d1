"""The port's public surface against the JAX package's, on the CPU: the
``repro_torch.core`` facade, the names of every ``core`` module, the
examples' twins' imports and the console scripts.

Draws on the JAX side are scoped to ``jax.threefry_partitionable(False)``,
the scheme the port reproduces; values are held bit for bit.
"""
import ast
import json
import os
import subprocess
import sys
import tomllib

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro.core import rng as jrng
from repro.core.simulation import build_mcs_fn as jbuild_mcs_fn
from repro_torch.core import engines, params, results, rng, simulation
from repro_torch.core import threefry, trials

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")

# names of the reference's core modules that exist only because it runs
# on JAX, each beside the port's stand-in ("module:attribute" in
# repro_torch, resolved by the test)
JAX_ONLY = {
    "jax": "repro_torch.core.threefry:PRNGKey",       # keys and draws
    "jnp": "repro_torch.core.lattice:init_grid",      # torch tensors
    "lax": "repro_torch.core.reference:run_proposals",  # the scan (S1)
    "Mesh": "repro_torch.parallel.sharding:LatticeMesh",
    "NamedSharding": "repro_torch.parallel.sharding:LatticeMesh",
    "P": "repro_torch.parallel.sharding:PodMesh",
    "shard_map": "repro_torch.core.sharded:make_local_round_batch",
    # a NamedSharding of the lattice / of the trial axis
    "lattice_sharding": "repro_torch.core.sharded:place",
    "pod_sharding": "repro_torch.core.trials:pod_devices",
}


def _public_names(path):
    """A module's top-level definitions and the names it imports from
    ``jax``, less those starting with ``_``."""
    tree = ast.parse(open(path).read())
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            out.add(node.target.id)
        elif isinstance(node, ast.Import):
            out.update((a.asname or a.name).split(".")[0] for a in node.names
                       if a.name.split(".")[0] == "jax")
        elif isinstance(node, ast.ImportFrom) and (
                node.module or "").split(".")[0] == "jax":
            out.update(a.asname or a.name for a in node.names)
    return {n for n in out if not n.startswith("_")}


def test_facade_exports_the_references_names_in_order():
    assert tcore.__all__ == jcore.__all__
    for name in tcore.__all__:
        assert getattr(tcore, name) is not None, name


def test_every_reference_core_name_has_a_counterpart():
    missing = {}
    ref_dir = os.path.join(SRC, "repro", "core")
    for fname in sorted(os.listdir(ref_dir)):
        if not fname.endswith(".py") or fname == "__init__.py":
            continue
        mod = __import__(f"repro_torch.core.{fname[:-3]}",
                         fromlist=["_"])
        lack = sorted(n for n in _public_names(os.path.join(ref_dir, fname))
                      if not hasattr(mod, n) and n not in JAX_ONLY)
        if lack:
            missing[fname] = lack
    assert missing == {}
    for stand_in in JAX_ONLY.values():
        module, attr = stand_in.split(":")
        assert hasattr(__import__(module, fromlist=["_"]), attr), stand_in


def test_engines_alias_is_live(monkeypatch):
    name = "surface_test_engine"
    assert name not in tcore.ENGINES and name not in params.ENGINES
    monkeypatch.setitem(engines._REGISTRY, name,
                        engines._REGISTRY["batched"])
    assert name in tcore.ENGINES and name in params.ENGINES
    assert tcore.ENGINES == engines.engine_names()
    with pytest.raises(AttributeError):
        tcore.NO_SUCH_NAME


def test_results_satisfy_run_result():
    sim = simulation.SimResult(grid=np.zeros((2, 2), np.int32))
    tr = trials.TrialResult(
        survival=np.ones((1, 3), bool), densities=np.zeros((1, 4)),
        stasis_mcs=np.zeros(1, np.int64),
        extinction_mcs=np.zeros((1, 3), np.int64), mcs_completed=0,
        kept_fraction=1.0, n_trials=1, n_devices=1)
    assert isinstance(sim, results.RunResult)
    assert isinstance(tr, results.RunResult)
    assert not isinstance(object(), results.RunResult)
    assert tcore.RunResult is results.RunResult


def test_tile_proposal_batch_equals_reference():
    with jax.threefry_partitionable(False):
        want = jrng.tile_proposal_batch(jax.random.PRNGKey(7), 5, 33, 18, 4)
    got = rng.tile_proposal_batch(threefry.PRNGKey(7), 5, 33, 18, 4)
    for a, b in zip(want, got):
        assert b.shape == (5, 33) and b.dtype == {
            "int32": torch.int32, "float32": torch.float32}[str(a.dtype)]
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("engine", ["batched", "sublattice", "reference"])
def test_build_mcs_fn_equals_reference(engine):
    """Three MCS keyed by the reference's chain, each held bit for bit."""
    from repro.core.lattice import init_grid as jinit
    from repro.core.params import EscgParams as JParams
    p = params.EscgParams(length=16, height=16, species=3, mobility=1e-4,
                          engine=engine, tile=(8, 8))
    jp = JParams(length=16, height=16, species=3, mobility=1e-4,
                 engine=engine, tile=(8, 8))
    one = simulation.build_mcs_fn(p, None, "cpu")
    with jax.threefry_partitionable(False):
        jone = jbuild_mcs_fn(jp, jax.numpy.asarray(
            np.asarray(tcore.dominance.circulant(3))))
        key = jax.random.PRNGKey(0)
        jgrid = jinit(key, 16, 16, 3, 0.1)
        grid = torch.from_numpy(np.asarray(jgrid).copy())
        for _ in range(3):
            key, k = jax.random.split(key)
            jgrid, jkept, jatt = jone(jgrid, k)
            grid, kept, att = one(grid, torch.from_numpy(
                np.asarray(jax.random.key_data(k)).astype(np.int64)))
            np.testing.assert_array_equal(grid.numpy(), np.asarray(jgrid))
            assert int(kept) == int(jkept) and int(att) == int(jatt)


def test_build_observe_is_the_pipelines_row():
    from repro_torch.core import observables
    p = params.EscgParams(length=8, height=8, observables=(
        "interface_length",))
    grid = torch.zeros((8, 8), dtype=torch.int32)
    counts = torch.tensor([64, 0, 0, 0], dtype=torch.int32)
    row = observables.build_observe(p)(grid, counts)
    assert torch.equal(row, observables.build_pipeline(p).row(grid, counts))
    assert trials.POD_AXIS == "pod"


def test_facade_and_twins_import_neither_jax_nor_repro():
    code = ("import sys\n"
            "import repro_torch.core\n"
            "import repro_torch.examples.quickstart\n"
            "import repro_torch.examples.park_alliances\n"
            "import repro_torch.examples.zhong_ablated_rpsls\n"
            "import repro_torch.examples.escg_longrun\n"
            "import repro_torch.examples.train_lm\n"
            "import torch\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "print(bad, torch.cuda.is_initialized())\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[] False"


def test_console_scripts_resolve_to_callables():
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    assert scripts["escg_run_torch"] == "repro_torch.launch.escg_run:main"
    assert scripts["escg_serve_torch"] == "repro_torch.launch.serve:main"
    for target in scripts.values():
        module, attr = target.split(":")
        assert callable(getattr(__import__(module, fromlist=["_"]), attr))
    assert json.dumps(sorted(scripts)) == json.dumps(
        ["escg_run", "escg_run_torch", "escg_serve", "escg_serve_torch"])
