"""The port's CLI (``repro_torch.launch.escg_run``, ``core/io.py``, the CLI
layer of ``core/params.py`` and ``core/scenarios.py``) against the JAX
package's, on the CPU.

Both CLIs run in this process on the same arguments (the port's with
``--device cpu``), each into the same output directory in turn, and the
files they write are compared: ``grid.csv``, ``densities.csv`` and
``dominance.csv`` byte for byte, ``params.csv`` and ``trials.json`` as
parsed JSON, ``state.npz`` and snapshots array for array (dtypes
included), and the deterministic lines they print. The JAX runs scope
``jax.threefry_partitionable(False)``. The reference's Pallas update
kernels do not run on the installed JAX, so its ``pallas_fused`` runs
through the kernels' plain reference: ``philox_proposal_fields`` feeding
``sublattice.run_round``, patched into ``repro.kernels.ops`` for the run.
"""
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.ops as jops
from repro.core import dominance as jdm
from repro.core import io as jio
from repro.core import params as jparams
from repro.core import scenarios as jscenarios
from repro.core import sublattice as jsublattice
from repro.core.rng import ProposalBatch
from repro.kernels.philox import philox_proposal_fields
from repro.launch import escg_run as jcli
from repro_torch.core import io, params, scenarios, threefry
from repro_torch.core.simulation import simulate
from repro_torch.launch import escg_run as cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
PRESETS = ("park3", "zhong_density", "nspecies5", "probabilistic",
           "asym_rps")


# ------------------------- the JAX side's plain kernels -------------------- #

def _fused_props(shape, seed, round_idx, tile_shape, k, nbhd):
    (h, w), (th, tw) = shape, tile_shape
    n_tiles = (h // th) * (w // tw)
    seed = jnp.asarray(seed, jnp.uint32)
    fields = philox_proposal_fields(
        jnp.arange(n_tiles * k, dtype=jnp.uint32), round_idx, seed[0],
        seed[1], (th - 2) * (tw - 2), nbhd)
    return ProposalBatch(*(f.reshape(n_tiles, k) for f in fields))


def _plain_round_fused(grid, seed, round_idx, shift, dom, tile_shape,
                       k_per_tile, t_eps, t_eps_mu, neighbourhood=4,
                       interpret=None, roll_back=True, tile_offset=None,
                       grid_tiles_w=None):
    assert tile_offset is None and grid_tiles_w is None
    props = _fused_props(grid.shape, seed, round_idx, tile_shape,
                         k_per_tile, neighbourhood)
    return jsublattice.run_round(grid, props, shift, tile_shape, t_eps,
                                 t_eps_mu, jnp.asarray(dom, jnp.float32),
                                 roll_back=roll_back)


def _plain_rounds_fused(grid, seeds, shifts, dom, tile_shape, k_per_tile,
                        t_eps, t_eps_mu, species, neighbourhood=4,
                        interpret=None, tile_offset=None,
                        grid_tiles_w=None):
    counts = []
    for t in range(seeds.shape[0]):
        grid = _plain_round_fused(grid, seeds[t], jnp.uint32(0), shifts[t],
                                  dom, tile_shape, k_per_tile, t_eps,
                                  t_eps_mu, neighbourhood, roll_back=False)
        counts.append(jnp.bincount(grid.reshape(-1).astype(jnp.int32),
                                   length=species + 1))
    return grid, jnp.stack(counts).astype(jnp.int32)


@pytest.fixture
def jax_plain_fused(monkeypatch):
    monkeypatch.setattr(jops, "escg_round_fused", _plain_round_fused)
    monkeypatch.setattr(jops, "escg_rounds_fused", _plain_rounds_fused)


# --------------------------------- runners --------------------------------- #

def _jax_main(argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["escg_run"] + list(argv))
    with jax.threefry_partitionable(False):
        jcli.main()


def _port_main(argv):
    cli.main(list(argv) + ["--device", "cpu"])


def _printed(text):
    """The lines both CLIs print alike: no wall times, no save paths."""
    return [line for line in text.splitlines()
            if "MCS in" not in line and "saved to" not in line]


def _run(tmp, name, which, argv, monkeypatch, capsys, state=None):
    """Run one CLI into ``tmp/run`` (seeded with a copy of ``state``),
    then move the directory to ``tmp/name``; returns the printed lines."""
    work = tmp / "run"
    if work.exists():
        shutil.rmtree(work)
    if state is not None:
        shutil.copytree(state, work)
    capsys.readouterr()
    argv = list(argv) + ["--outDir", str(work)]
    if which == "jax":
        _jax_main(argv, monkeypatch)
    else:
        _port_main(argv)
    out = capsys.readouterr().out
    if work.exists():
        work.rename(tmp / name)
    return _printed(out)


def _both(tmp, tag, argv, monkeypatch, capsys, state=None):
    """JAX then the port on ``argv``: the two directories and the
    printed lines, which must agree."""
    lines_j = _run(tmp, f"{tag}_jax", "jax", argv, monkeypatch, capsys,
                   state=state)
    lines_p = _run(tmp, f"{tag}_port", "port", argv, monkeypatch, capsys,
                   state=state)
    assert lines_p == lines_j
    return tmp / f"{tag}_jax", tmp / f"{tag}_port"


def _same_files(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    assert names, "nothing was written"
    for name in names:
        pa, pb = os.path.join(a, name), os.path.join(b, name)
        if name in ("grid.csv", "densities.csv", "dominance.csv"):
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                assert fa.read() == fb.read(), name
        elif name in ("params.csv", "trials.json"):
            with open(pa) as fa, open(pb) as fb:
                assert json.load(fa) == json.load(fb), name
        elif name.endswith(".npz"):
            with np.load(pa) as za, np.load(pb) as zb:
                assert sorted(za.files) == sorted(zb.files)
                for f in za.files:
                    assert za[f].dtype == zb[f].dtype, (name, f)
                    np.testing.assert_array_equal(za[f], zb[f])
        elif name.endswith(".npy"):
            xa, xb = np.load(pa), np.load(pb)
            assert xa.dtype == xb.dtype
            np.testing.assert_array_equal(xa, xb)
        else:
            raise AssertionError(f"unexpected file {name}")
    return names


# ------------------------------ save / resume ------------------------------ #

BATCHED_SAVE = ["--length", "32", "--height", "32", "--mcs", "40",
                "--engine", "batched", "--save", "true", "--chunkMcs", "20",
                "--empty", "0.1", "--printFrequency", "10"]


def test_batched_save_then_resume_match_and_cross_resume(tmp_path,
                                                         monkeypatch,
                                                         capsys):
    """Save at MCS 40, resume to 60: the same files from both CLIs, and a
    state saved by either resumes in the other to the same result."""
    dj, dp = _both(tmp_path, "save", BATCHED_SAVE, monkeypatch, capsys)
    assert _same_files(dj, dp) == ["densities.csv", "dominance.csv",
                                   "grid.csv", "params.csv", "state.npz"]
    with np.load(dj / "state.npz") as z:
        assert "key" not in z.files and int(z["mcs"]) == 40
    resume = ["--resume", "true", "--mcs", "60"]
    rj, rp = _both(tmp_path, "resume", resume, monkeypatch, capsys,
                   state=dj)
    _same_files(rj, rp)
    with np.load(rj / "state.npz") as z:
        assert int(z["mcs"]) == 60
    # across packages: the port resumes the JAX save, JAX the port's
    _run(tmp_path, "cross_port", "port", resume, monkeypatch, capsys,
         state=dj)
    _same_files(rj, tmp_path / "cross_port")
    _run(tmp_path, "cross_jax", "jax", resume, monkeypatch, capsys,
         state=dp)
    _same_files(rj, tmp_path / "cross_jax")


def test_resume_reads_a_saved_key_in_either_form(tmp_path, monkeypatch,
                                                 capsys):
    """A state whose ``state.npz`` holds a key (uint32 (2,), as JAX
    writes a raw key) resumes from that key in both CLIs, whichever
    package wrote it."""
    dj, _ = _both(tmp_path, "save", BATCHED_SAVE, monkeypatch, capsys)
    p, grid, mcs, dom, _ = jio.load_state(str(dj))
    with jax.threefry_partitionable(False):
        jkey = jax.random.fold_in(jax.random.PRNGKey(99), 5)
    tkey = threefry.fold_in(threefry.PRNGKey(99), 5)
    np.testing.assert_array_equal(np.asarray(jkey), tkey.numpy())
    keyed_j, keyed_p = tmp_path / "keyed_j", tmp_path / "keyed_p"
    jio.save_state(str(keyed_j), p, grid, mcs, dom, key=jkey)
    io.save_state(str(keyed_p), params.EscgParams.from_json(p.to_json()),
                  torch.from_numpy(grid), mcs, dom, key=tkey)
    _same_files(keyed_j, keyed_p)
    with np.load(keyed_p / "state.npz") as z:
        assert z["key"].dtype == np.uint32 and z["key"].shape == (2,)
    loaded = io.load_state(str(keyed_j))[4]
    assert loaded.dtype == torch.int64 and torch.equal(loaded, tkey)
    resume = ["--resume", "true", "--mcs", "50"]
    rj, rp = _both(tmp_path, "kres", resume, monkeypatch, capsys,
                   state=keyed_p)
    _same_files(rj, rp)
    # the saved key was used: the run differs from the seed's fold-in
    plain, _ = _both(tmp_path, "pres", resume, monkeypatch, capsys,
                     state=dj)
    assert (rj / "grid.csv").read_bytes() != (plain / "grid.csv").read_bytes()


# ------------------------------ engines and modes -------------------------- #

TILED = ["--length", "32", "--height", "32", "--tile", "8", "8", "--mcs",
         "10", "--chunkMcs", "5", "--save", "true", "--empty", "0.1",
         "--mobility", "1e-3", "--species", "5", "--printFrequency", "3"]


@pytest.mark.parametrize("engine,extra", [
    ("sublattice", []),
    ("pallas_fused", []),
    ("pallas_fused", ["--kMcs", "4"]),
])
def test_tiled_engines_write_the_same_files(engine, extra, tmp_path,
                                            monkeypatch, capsys,
                                            jax_plain_fused):
    dj, dp = _both(tmp_path, engine, TILED + ["--engine", engine] + extra,
                   monkeypatch, capsys)
    _same_files(dj, dp)


def test_kmcs_run_writes_the_kmcs1_files(tmp_path, monkeypatch, capsys):
    """``--kMcs 4`` is bit-identical to ``--kMcs 1`` in the port's CLI."""
    base = TILED + ["--engine", "pallas_fused"]
    _run(tmp_path, "k1", "port", base, monkeypatch, capsys)
    _run(tmp_path, "k4", "port", base + ["--kMcs", "4"], monkeypatch,
         capsys)
    a, b = tmp_path / "k1", tmp_path / "k4"
    with open(a / "params.csv") as fa, open(b / "params.csv") as fb:
        pa, pb = json.load(fa), json.load(fb)
    assert pa.pop("k_mcs") == 1 and pb.pop("k_mcs") == 4 and pa == pb
    for name in ("grid.csv", "densities.csv"):
        assert (a / name).read_bytes() == (b / name).read_bytes()


def test_trials_write_the_same_trial_result(tmp_path, monkeypatch, capsys):
    argv = ["--length", "16", "--height", "16", "--mcs", "12",
            "--chunkMcs", "5", "--trials", "4", "--save", "true",
            "--species", "4", "--empty", "0.1"]
    dj, dp = _both(tmp_path, "trials", argv, monkeypatch, capsys)
    assert _same_files(dj, dp) == ["trials.json"]


def test_scenario_with_overriding_flag(tmp_path, monkeypatch, capsys):
    argv = ["--scenario", "zhong_density", "--mobility", "5e-4",
            "--length", "24", "--height", "24", "--mcs", "12",
            "--chunkMcs", "6", "--save", "true", "--printFrequency", "4"]
    dj, dp = _both(tmp_path, "zhong", argv, monkeypatch, capsys)
    _same_files(dj, dp)
    with open(dp / "params.csv") as f:
        saved = json.load(f)
    assert saved["mobility"] == 5e-4 and saved["species"] == 5
    assert tuple(saved["observables"]) == ("densities",)


def test_dominance_import(tmp_path, monkeypatch, capsys):
    csv = tmp_path / "dom.csv"
    csv.write_text(jdm.to_csv(jdm.zhong_ablated_rpsls()))
    argv = ["--length", "16", "--height", "16", "--mcs", "6",
            "--dominance", str(csv), "--engine", "reference",
            "--chunkMcs", "3", "--save", "true", "--empty", "0.1"]
    dj, dp = _both(tmp_path, "dom", argv, monkeypatch, capsys)
    _same_files(dj, dp)
    with open(dp / "params.csv") as f:
        assert json.load(f)["species"] == 5


def test_snapshots(tmp_path, monkeypatch, capsys):
    argv = ["--length", "16", "--height", "16", "--mcs", "12",
            "--chunkMcs", "3", "--snapshotEvery", "6", "--empty", "0.1"]
    dj, dp = _both(tmp_path, "snap", argv, monkeypatch, capsys)
    assert _same_files(dj, dp) == ["snapshot_00000006.npy",
                                   "snapshot_00000012.npy"]


def test_observables_flag(tmp_path, monkeypatch, capsys):
    argv = ["--length", "16", "--height", "16", "--mcs", "10",
            "--chunkMcs", "4", "--save", "true", "--empty", "0.1",
            "--observables", "densities,interface_length",
            "--printFrequency", "2"]
    dj, dp = _both(tmp_path, "obs", argv, monkeypatch, capsys)
    _same_files(dj, dp)
    with open(dp / "params.csv") as f:
        assert tuple(json.load(f)["observables"]) == (
            "densities", "interface_length")


# ------------------------------- io directly -------------------------------- #

def test_io_writers_take_a_tensor_and_match_the_reference(tmp_path):
    rng = np.random.default_rng(0)
    grid = rng.integers(0, 6, size=(7, 9)).astype(np.int32)
    hist = rng.random((5, 6))
    io.export_grid_csv(str(tmp_path / "a.csv"), torch.from_numpy(grid), 17)
    jio.export_grid_csv(str(tmp_path / "b.csv"), grid, 17)
    assert (tmp_path / "a.csv").read_bytes() == \
        (tmp_path / "b.csv").read_bytes()
    back, mcs = io.import_grid_csv(str(tmp_path / "a.csv"))
    np.testing.assert_array_equal(back, grid)
    assert mcs == 17 and back.dtype == np.int32
    wide = rng.integers(0, 13, size=(4, 6)).astype(np.int16)  # two digits
    io.export_grid_csv(str(tmp_path / "w1.csv"), torch.from_numpy(wide), 2)
    jio.export_grid_csv(str(tmp_path / "w2.csv"), wide, 2)
    assert (tmp_path / "w1.csv").read_bytes() == \
        (tmp_path / "w2.csv").read_bytes()
    io.export_densities_csv(str(tmp_path / "d1.csv"), hist)
    jio.export_densities_csv(str(tmp_path / "d2.csv"), hist)
    assert (tmp_path / "d1.csv").read_bytes() == \
        (tmp_path / "d2.csv").read_bytes()
    path = io.save_snapshot(str(tmp_path / "snaps"),
                            torch.from_numpy(grid).to(torch.int8), 3)
    assert path.endswith("snapshot_00000003.npy")
    assert np.load(path).dtype == np.int32


def test_csv_fallback_when_npz_missing(tmp_path):
    p = params.EscgParams(length=8, height=8, species=3)
    grid = np.arange(64, dtype=np.int32).reshape(8, 8) % 4
    io.save_state(str(tmp_path), p, grid, 9,
                  jdm.circulant(3).astype(np.float32))
    os.remove(tmp_path / "state.npz")
    for load in (io.load_state, jio.load_state):
        lp, g, mcs, dom, key = load(str(tmp_path))
        np.testing.assert_array_equal(g, grid)
        assert mcs == 9 and key is None and lp.length == 8
        np.testing.assert_array_equal(dom, jdm.circulant(3))


# ---------------------------- registry matrices ----------------------------- #

def test_registry_matrices_equal_the_reference():
    assert cli.engine_matrix_markdown() == jcli.engine_matrix_markdown()
    assert cli.scenario_matrix_markdown() == jcli.scenario_matrix_markdown()
    readme = os.path.join(REPO, "README.md")
    assert cli.readme_matrix_drift(readme) is None
    assert cli.readme_scenario_drift(readme) is None


def test_list_check_readme_exits_zero(capsys):
    cli.main(["--listEngines", "--listScenarios", "--check",
              os.path.join(REPO, "README.md")])
    out = capsys.readouterr().out
    assert "engine matrix matches" in out
    assert "scenario matrix matches" in out
    cli.main(["--listEngines", "--markdown"])
    assert capsys.readouterr().out.strip() == cli.engine_matrix_markdown()


def test_check_flags_a_drifted_readme(tmp_path):
    readme = tmp_path / "README.md"
    with open(os.path.join(REPO, "README.md")) as f:
        readme.write_text(f.read().replace("| `batched` |", "| `batch` |"))
    with pytest.raises(SystemExit, match="drifted"):
        cli.main(["--listEngines", "--check", str(readme)])


# ------------------------------- CLI layer ---------------------------------- #

@pytest.mark.parametrize("argv", [
    ["--scenario", "zhong_density", "--mobility", "5e-4", "--empty", "0.2"],
    ["--scenario", "zhong_density", "--mobility", "3e-5"],   # the default
    ["--scenario", "park3", "--flux", "false"],
    ["--scenario", "park3", "--species", "3", "--sigma", "2"],
    ["--scenario", "nspecies7", "--species", "4", "--neighbourhood", "8"],
    ["--scenario", "probabilistic", "--epsilon", "0.5", "--mu", "1.0"],
])
def test_scenario_from_cli_keeps_the_default_rule(argv):
    """A flag equal to the parser's default counts as not passed."""
    want = jscenarios.scenario_from_cli(
        jcli.build_parser().parse_args(argv), jcli.build_parser())
    got = scenarios.scenario_from_cli(
        cli.build_parser().parse_args(argv), cli.build_parser())
    assert got.to_json() == want.to_json()
    if "3e-5" in argv:
        assert got.mobility == 1e-4          # the preset's, not the flag's


@pytest.mark.parametrize("scenario", PRESETS)
@pytest.mark.parametrize("engine", ("batched", "sublattice", "sharded_pod"))
def test_scenario_setup_matches_and_runs(scenario, engine):
    """Every preset resolves through ``--scenario`` to the reference's
    params and network on every engine tier, and runs."""
    argv = ["--scenario", scenario, "--engine", engine, "--length", "16",
            "--height", "16", "--mcs", "2", "--chunkMcs", "2", "--tile",
            "8", "16"]
    jap, ap = jcli.build_parser(), cli.build_parser()
    _, jp, jdom = jcli.scenario_setup(jap.parse_args(argv), jap)
    sc, p, dom = cli.scenario_setup(ap.parse_args(argv), ap)
    assert json.loads(p.to_json()) == json.loads(jp.to_json())
    np.testing.assert_array_equal(dom, np.asarray(jdom))
    assert p.engine == engine and p.species == sc.species
    res = simulate(p, dom, stop_on_stasis=False, device="cpu")
    assert res.mcs_completed == 2
    np.testing.assert_allclose(res.densities.sum(axis=1), 1.0, atol=1e-6)


@pytest.mark.parametrize("argv", [
    [],
    ["--tile", "8", "16", "--engine", "sublattice", "--length", "32"],
    ["--engine", "sharded", "--shardGrid", "2", "2", "--tile", "8", "8",
     "--length", "32", "--height", "32", "--localKernel", "pallas"],
    ["--engine", "sharded_pod", "--meshShape", "2x1x2", "--tile", "8",
     "8", "--length", "32", "--height", "32"],
    ["--observables", "densities, interface_length", "--obsCapacity", "7"],
    ["--observables", "none", "--kMcs", "3", "--engine", "pallas_fused",
     "--length", "256", "--height", "64"],
    ["--flux", "no", "--neighbourhood", "8", "--epsilon", "0.25",
     "--numRandoms", "80000", "--maxStep", "true", "--cellDtype", "int8"],
])
def test_params_from_args_matches(argv):
    want = jparams.params_from_args(jcli.build_parser().parse_args(argv))
    got = params.params_from_args(cli.build_parser().parse_args(argv))
    assert json.loads(got.to_json()) == json.loads(want.to_json())
    assert got.proposals_per_round == want.proposals_per_round
    assert got.mcs_per_round == want.mcs_per_round
    sc, eng, run = got.to_scenario("x")
    assert params.EscgParams.from_scenario(sc, eng, run) == got


@pytest.mark.parametrize("text", ["2,2,2", "4x1x2", "1,2,x3", "2,2", "a,b,c"])
def test_mesh_shape_parser_matches(text):
    def parse(fn):
        try:
            return fn(text)
        except Exception as e:   # the same kind of error for bad input
            return type(e).__name__
    assert parse(params._mesh_shape) == parse(jparams._mesh_shape)


@pytest.mark.parametrize("text", [None, "", "none", " NONE ", "densities",
                                  "densities, interface_length,",
                                  " a ,, b "])
def test_parse_observables_matches(text):
    assert params.parse_observables(text) == jparams.parse_observables(text)


def test_engine_choices_are_the_port_registry():
    from repro_torch.core import engines
    ap = cli.build_parser()
    action = next(a for a in ap._actions if a.dest == "engine")
    assert tuple(action.choices) == engines.engine_names()
    assert engines.engine_names() == tuple(
        s.name for s in engines.engine_specs())


def test_device_flag_parses_lists():
    assert cli.parse_device(None) is None
    assert cli.parse_device("cpu") == "cpu"
    assert cli.parse_device("cuda:0,cuda:0") == ["cuda:0", "cuda:0"]


# --------------------------- as a user starts it ---------------------------- #

def _module(args, env_extra=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-m"] + args, capture_output=True,
                          text=True, timeout=300, env=env)


def test_module_entry_point_runs_on_the_cpu_and_needs_a_card_otherwise(
        tmp_path):
    out_dir = str(tmp_path / "run")
    ok = _module(["repro_torch.launch.escg_run", "--length", "16",
                  "--height", "16", "--mcs", "4", "--chunkMcs", "2",
                  "--device", "cpu", "--save", "true", "--outDir", out_dir,
                  "--printLaunches"])
    assert ok.returncode == 0, ok.stderr
    assert "4 MCS" in ok.stdout and os.path.exists(
        os.path.join(out_dir, "state.npz"))
    line = next(x for x in ok.stdout.splitlines()
                if x.startswith("[escg] kernel launches "))
    counts = json.loads(line[len("[escg] kernel launches "):])
    # the plain path on the CPU launches no kernel
    assert counts and not any(counts.values())
    if not torch.cuda.is_available():
        bad = _module(["repro_torch.launch.escg_run", "--length", "16",
                       "--height", "16", "--mcs", "2"])
        assert bad.returncode != 0
        assert "CUDA is not available" in bad.stderr
