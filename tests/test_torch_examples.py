"""The examples' twins (``repro_torch.examples``) against the repo's own
``examples/``, on the CPU: each pair runs at a small size in its own
working directory under ``tmp_path``, the example on the JAX package
(draws under ``jax.threefry_partitionable(False)``, the scheme the port
reproduces) and the twin with ``--device cpu``.

Lattices, counts, densities and printed lines are held bit for bit (the
longrun's and the LM's lines that print a time are left out); the LM's
losses within relative 1e-5, ``tests/test_torch_lm.py``'s tolerance for
a loss. The quickstart fixes its size in code, so a smaller ``RunConfig``
is put in both modules' namespaces; the examples are not edited.
"""
import importlib
import importlib.util
import os
import sys

import jax
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _twin(name):
    return importlib.import_module(f"repro_torch.examples.{name}")


def _run_pair(name, args, tmp_path, monkeypatch, capsys, patch=None):
    """Run the JAX example in ``tmp_path/jax`` and the twin in
    ``tmp_path/port`` on the same flags; returns both directories and
    both outputs."""
    ex, tw = _example(name), _twin(name)
    if patch is not None:
        patch(ex, tw)
    out = {}
    for side in ("jax", "port"):
        work = tmp_path / side
        work.mkdir()
        monkeypatch.chdir(work)
        if side == "jax":
            monkeypatch.setattr(sys, "argv", [name] + args)
            with jax.threefry_partitionable(False):
                ex.main()
        else:
            tw.main(args + ["--device", "cpu"])
        out[side] = capsys.readouterr().out
    return tmp_path / "jax", tmp_path / "port", out["jax"], out["port"]


def _same_files(a, b, names):
    for name in names:
        if name.endswith(".npz"):
            with np.load(a / name) as za, np.load(b / name) as zb:
                assert sorted(za.files) == sorted(zb.files), name
                for k in za.files:
                    np.testing.assert_array_equal(zb[k], za[k])
                    assert zb[k].dtype == za[k].dtype, (name, k)
        elif name.endswith(".npy"):
            np.testing.assert_array_equal(np.load(b / name),
                                          np.load(a / name))
        else:
            assert (b / name).read_bytes() == (a / name).read_bytes(), name


def test_quickstart_twin_writes_the_examples_files(tmp_path, monkeypatch,
                                                   capsys):
    def smaller(*mods):
        for mod in mods:
            cls = mod.RunConfig
            monkeypatch.setattr(mod, "RunConfig", lambda cls=cls, **kw: cls(
                **{**kw, "length": 48, "height": 48, "mcs": 30,
                   "chunk_mcs": 10}))
    a, b, oa, ob = _run_pair("quickstart", [], tmp_path, monkeypatch,
                             capsys, patch=smaller)
    _same_files(a / "out" / "quickstart", b / "out" / "quickstart",
                ["state.npz", "grid.csv", "params.csv", "dominance.csv",
                 "densities.csv"])
    assert ob == oa and "MCS    30" in ob


def test_zhong_twin_writes_the_examples_densities(tmp_path, monkeypatch,
                                                  capsys):
    a, b, oa, ob = _run_pair("zhong_ablated_rpsls",
                             ["--L", "24", "--mcs", "60"], tmp_path,
                             monkeypatch, capsys)
    _same_files(a / "out" / "zhong", b / "out" / "zhong", ["densities.csv"])
    assert ob == oa


def test_park_twin_prints_the_examples_statistics(tmp_path, monkeypatch,
                                                  capsys):
    _, _, oa, ob = _run_pair("park_alliances",
                             ["--L", "12", "--trials", "4", "--mcs", "30",
                              "--mobility", "1e-4"], tmp_path, monkeypatch,
                             capsys)
    assert ob == oa and "survivor-count histogram" in ob


def _untimed(text):
    return [ln for ln in text.splitlines() if " in " not in ln]


def test_longrun_twin_and_its_resume_equal_the_example(tmp_path,
                                                       monkeypatch, capsys):
    """A run of 60 MCS, then the same directory resumed to 90 (keyed by
    ``fold_in(PRNGKey(0), 60)``, as the example is): ``state.npz`` equal
    after each. The resumed part is not the uninterrupted run's: neither
    package saves the run's key in a checkpoint."""
    ex, tw = _example("escg_longrun"), _twin("escg_longrun")
    outs = {}
    for side in ("jax", "port"):
        work = tmp_path / side
        work.mkdir()
        monkeypatch.chdir(work)
        for mcs in ("60", "90"):
            args = ["--L", "32", "--mcs", mcs]
            if side == "jax":
                monkeypatch.setattr(sys, "argv", ["longrun"] + args)
                with jax.threefry_partitionable(False):
                    ex.main()
            else:
                tw.main(args + ["--device", "cpu"])
            (work / f"state_{mcs}.npz").write_bytes(
                (work / "out" / "longrun" / "state.npz").read_bytes())
        outs[side] = _untimed(capsys.readouterr().out)
    a, b = tmp_path / "jax", tmp_path / "port"
    _same_files(a, b, ["state_60.npz", "state_90.npz"])
    _same_files(a / "out" / "longrun", b / "out" / "longrun",
                ["grid.csv", "params.csv", "dominance.csv"])
    assert outs["port"] == outs["jax"]
    assert "[longrun] resuming at MCS 60" in outs["port"]


def test_train_lm_twin_losses_equal_the_example(tmp_path, monkeypatch,
                                                capsys):
    """Two steps of the 13m preset on a batch of 2 x 32 tokens: each
    step's loss within relative 1e-5 of the example's."""
    import repro.launch.train as jtrain
    import repro_torch.launch.train as ttrain
    losses = {}

    def recording(mod, side):
        base = mod.FaultTolerantLoop

        class Loop(base):
            def run(self, *a, on_metrics=None, **k):
                def record(step, m):
                    losses.setdefault(side, []).append(float(m["loss"]))
                    on_metrics(step, m)
                return super().run(*a, on_metrics=record, **k)
        monkeypatch.setattr(mod, "FaultTolerantLoop", Loop)

    recording(jtrain, "jax")
    recording(ttrain, "port")
    _, b, oa, ob = _run_pair(
        "train_lm", ["--steps", "2", "--batch", "2", "--seq", "32",
                     "--log_every", "1"], tmp_path, monkeypatch, capsys)
    assert len(losses["jax"]) == len(losses["port"]) == 2
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=1e-5)
    assert (b / "out" / "train_lm").is_dir()
    assert "[train] done: steps 0->2" in ob
