"""The port's checkpointing and fault-tolerant loop
(``repro_torch.runtime``) on the CPU: the reference's
``tests/test_checkpoint.py`` and ``tests/test_fault.py`` cases on the
port, and checkpoints crossing between the two packages in both
directions (the same directory layout, manifest and payloads):

* a train checkpoint written by JAX restores in the port and steps on to
  JAX's next state (within 1e-5, as ``test_torch_lm.py``'s steps);
* a float32 checkpoint written by the port restores in JAX, exactly;
* JAX's bfloat16 payloads (``'<V2'`` ``.npy``) read bit for bit, and the
  port writes the same bytes;
* a lattice sharded over a (2, 2) mesh of 4 fake JAX devices, saved by
  JAX, restores onto a (2, 2) ``LatticeMesh`` of ``cpu``, and a
  ``ShardedLattice`` saved by the port restores whole in JAX (one
  subprocess).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs.base import ShapeConfig as JShape
from repro.data import synthetic as jsyn
from repro.models import build_model as jbuild
from repro.runtime import train_lib as jtl
from repro.runtime.checkpoint import CheckpointManager as JCkpt
from repro_torch import convert
from repro_torch.configs import ARCHS
from repro_torch.core import lattice, sharded, threefry
from repro_torch.launch import train as train_cli
from repro_torch.models import build_model
from repro_torch.models.spec import tree_leaves
from repro_torch.optim import compression
from repro_torch.parallel.sharding import LatticeMesh
from repro_torch.runtime import fault, train_lib
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.fault import FaultTolerantLoop, StragglerMonitor


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(8, 16, generator=g),
                       "b": torch.zeros(16)},
            "step": torch.tensor(7, dtype=torch.int32)}


def _equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


# --------------------- the reference's checkpoint cases -------------------- #

def test_roundtrip(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2, device="cpu")
    t = _tree()
    cm.save(7, t)
    step, got = cm.restore()
    assert step == 7 and _equal(got, t)


def test_retention_and_latest(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2, device="cpu")
    for s in (1, 2, 3, 4):
        cm.save(s, _tree(s))
    assert cm.all_steps() == [3, 4]
    assert cm.latest_step() == 4


def test_async_save_takes_a_host_copy(tmp_path):
    """``save(blocking=False)`` copies every leaf before it returns: an
    in-place update made while the writer runs never reaches the file
    (``.cpu()`` of a CPU tensor would be the same storage)."""
    cm = CheckpointManager(str(tmp_path), keep=3, device="cpu")
    t = _tree(1)
    want = {"params": {k: v.clone() for k, v in t["params"].items()},
            "step": t["step"].clone()}
    cm.save(1, t, blocking=False)
    t["params"]["w"].add_(1.0)
    t["step"].fill_(99)
    cm.wait()
    assert cm.latest_step() == 1
    assert _equal(cm.restore()[1], want)


def test_atomicity_marker(tmp_path):
    """A directory without the COMMITTED marker is invisible."""
    cm = CheckpointManager(str(tmp_path), keep=3, device="cpu")
    cm.save(5, _tree())
    os.makedirs(os.path.join(str(tmp_path), "step_0000000009"))
    assert cm.all_steps() == [5]


def test_restore_with_placement_tree(tmp_path):
    cm = CheckpointManager(str(tmp_path), device="cpu")
    t = _tree()
    cm.save(1, t)
    sh = {"params": {"w": torch.device("cpu"), "b": "cpu"}, "step": "cpu"}
    _, got = cm.restore(shardings=sh)
    assert _equal(got, t)


def test_missing_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path), device="cpu").restore()


def test_default_placement_is_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, _tree())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cm.restore()


# ---------------------- the reference's fault cases ------------------------ #

def _counter_step(state, batch):
    return {"x": state["x"] + batch}, {"loss": torch.tensor(0.0)}


def test_restart_resumes_from_checkpoint(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), keep=3, device="cpu")
    loop = FaultTolerantLoop(_counter_step, ckpt, ckpt_every=5,
                             max_restarts=2)
    fails = {17}
    state, end = loop.run(
        {"x": torch.tensor(0.0)}, lambda s: torch.tensor(1.0), 20,
        inject_failure=lambda s: s in fails and not fails.discard(s))
    assert end == 20 and loop.restarts == 1
    assert float(state["x"]) == 20.0


def test_restart_budget_exhausted(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), keep=3, device="cpu")
    loop = FaultTolerantLoop(_counter_step, ckpt, ckpt_every=5,
                             max_restarts=1)
    with pytest.raises(RuntimeError):
        loop.run({"x": torch.tensor(0.0)}, lambda s: torch.tensor(1.0), 20,
                 inject_failure=lambda s: s == 7)


def test_straggler_monitor_and_heartbeat(tmp_path):
    mon = StragglerMonitor(k=3.0)
    for _ in range(20):
        mon.record(0.1)
    assert mon.flagged == 0
    assert mon.record(1.0) and mon.flagged == 1
    hb = fault.Heartbeat(str(tmp_path / "hb"), interval_s=0.0)
    hb.beat(3)
    assert open(tmp_path / "hb").read().startswith("3 ")


def test_quantize_roundtrip_and_error_feedback():
    """The reference's compression cases: the int8 round trip is within
    half a quantum, and error feedback keeps tiny grads' signal."""
    x = torch.randn(16, 64, generator=torch.Generator().manual_seed(0)) * 3
    q, scale = compression.quantize_int8(x)
    assert q.dtype == torch.int8
    err = (x - compression.dequantize_int8(q, scale)).abs()
    assert float(err.max()) <= float(scale.max()) * 0.5 + 1e-6
    g_true = {"w": torch.full((8, 8), 0.001)}
    ef = {"w": torch.zeros((8, 8), dtype=torch.bfloat16)}
    total = torch.zeros((8, 8), dtype=torch.float64)
    for _ in range(50):
        g_c, ef = compression.compress_grads(g_true, ef)
        total += g_c["w"].double()
    np.testing.assert_allclose(total.numpy(), 50 * 0.001, rtol=0.15)
    assert float(ef["w"].double().abs().max()) < 0.01


# ------------------------- the LM train state ------------------------------ #

def _reduced(arch="granite-3-8b", **kw):
    return (jbuild(JARCHS[arch].reduced().replace(**kw)),
            build_model(ARCHS[arch].reduced().replace(**kw)))


def _jax_state(jm):
    with jax.threefry_partitionable(False):
        st = jtl.init_state(jm, jax.random.PRNGKey(0))
        b = jsyn.batch_for_model(jm, JShape("t", 32, 2, "train"), 0, 1)
    return st, b


def test_jax_train_checkpoint_restores_and_steps_on(tmp_path):
    """JAX trains one step and saves; the port restores that checkpoint
    (every leaf exactly) and takes the next step, equal to JAX's next
    step."""
    jm, tm = _reduced()
    st, b = _jax_state(jm)
    step = jax.jit(jtl.make_train_step(jm))
    s1, _ = step(st, b)
    JCkpt(str(tmp_path)).save(1, s1)
    s2, jmet = step(s1, b)

    n, got = CheckpointManager(str(tmp_path), device="cpu").restore()
    assert n == 1 and int(got["step"]) == 1
    for a, t in zip(jax.tree.leaves(s1), tree_leaves(got)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(a))
    t2, tmet = train_lib.make_train_step(tm)(
        got, convert.state_from_jax(jax.tree.map(np.asarray, b), "cpu"))
    assert int(t2["step"]) == 2
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=1e-5)
    for a, t in zip(jax.tree.leaves(s2), tree_leaves(t2)):
        np.testing.assert_allclose(t.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-5)


def test_port_checkpoint_restores_in_jax(tmp_path):
    """A float32 train state and an int32 lattice saved by the port
    restore in JAX, exactly."""
    _, tm = _reduced("pixtral-12b")
    st = train_lib.init_state(tm, threefry.PRNGKey(3), device="cpu")
    st["step"] = torch.tensor(5, dtype=torch.int32)
    grid = lattice.init_grid(threefry.PRNGKey(1), 16, 24, 3, 0.1,
                             device="cpu")
    CheckpointManager(str(tmp_path), device="cpu").save(
        5, {"state": st, "grid": grid})
    n, got = JCkpt(str(tmp_path)).restore()
    assert n == 5
    want = convert.state_to_numpy({"state": st, "grid": grid})
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, t in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.dtype == t.dtype and a.shape == t.shape
        np.testing.assert_array_equal(np.asarray(a), t)


def test_bf16_payloads_cross_bit_for_bit(tmp_path):
    """The reference writes a bfloat16 leaf as a ``'<V2'`` payload under
    ``"dtype": "bfloat16"``; the port reads its words exactly and writes
    the same bytes and the same manifest."""
    words = np.random.default_rng(0).integers(-2 ** 15, 2 ** 15, (6, 10),
                                              dtype=np.int16)
    words[0, :4] = [0, -32768, 0x7F80, 0x3F80]          # 0, -0, inf, 1
    arr = jnp.asarray(words.view(jnp.bfloat16))
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    JCkpt(jdir).save(2, {"w": arr, "s": jnp.int32(3)})
    _, got = CheckpointManager(jdir, device="cpu").restore()
    assert got["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["w"].view(torch.int16).numpy(), words)
    CheckpointManager(tdir, device="cpu").save(2, got)
    for name in ("manifest.json", "w.0.npy", "s.0.npy"):
        a = open(os.path.join(jdir, "step_0000000002", name), "rb").read()
        b = open(os.path.join(tdir, "step_0000000002", name), "rb").read()
        assert a == b, name
    meta = json.load(open(os.path.join(tdir, "step_0000000002",
                                       "manifest.json")))
    assert meta["leaves"]["w"]["dtype"] == "bfloat16"
    np.testing.assert_array_equal(
        convert.params_from_jax({"w": np.asarray(arr)}, "cpu")["w"]
        .view(torch.int16).numpy(), words)


def test_fault_loop_restart_equals_failure_free_run(tmp_path):
    """The train loop at granite-3-8b's reduced size: checkpoints every 2
    steps, a failure injected at step 5, restored from step 4; the final
    state equals a failure-free run's bit for bit."""
    _, tm = _reduced()
    step = train_lib.make_train_step(tm)

    def batches(s):
        from repro_torch.data import batch_for_model
        from repro_torch.configs import ShapeConfig
        return batch_for_model(tm, ShapeConfig("t", 16, 2, "train"), s, 0,
                               device="cpu")

    def run(d, fail):
        loop = FaultTolerantLoop(step, CheckpointManager(d, device="cpu"),
                                 ckpt_every=2)
        fails = {5} if fail else set()
        st = train_lib.init_state(tm, threefry.PRNGKey(0), device="cpu")
        out, end = loop.run(
            st, batches, 8,
            inject_failure=lambda s: s in fails and not fails.discard(s))
        return out, end, loop.restarts

    clean, end0, r0 = run(str(tmp_path / "a"), False)
    again, end1, r1 = run(str(tmp_path / "b"), True)
    assert (end0, r0, end1, r1) == (8, 0, 8, 1)
    assert int(again["step"]) == 8 and _equal(clean, again)


def test_train_cli_runs_and_resumes(tmp_path, capsys):
    """``python -m repro_torch.launch.train`` on the CPU: 4 steps with a
    checkpoint every 2, then ``--resume`` to 6."""
    args = ["--reduced", "--batch", "2", "--seq", "16", "--ckpt_dir",
            str(tmp_path), "--ckpt_every", "2", "--log_every", "1",
            "--device", "cpu"]
    train_cli.main(args + ["--steps", "4"])
    out = capsys.readouterr().out
    assert "steps 0->4" in out and "device=cpu" in out
    assert CheckpointManager(str(tmp_path), device="cpu").all_steps() == \
        [2, 4]
    train_cli.main(args + ["--steps", "6", "--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 4" in out and "steps 4->6" in out


def test_train_cli_needs_a_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(["--reduced", "--steps", "1"])


# ----------------------------- sharded leaves ------------------------------ #

def test_sharded_lattice_leaf_and_elastic_restore(tmp_path):
    """A ``ShardedLattice`` leaf (a trial batch on (2, 2)) is written block
    by block with its global bounds and restores onto (4, 1), onto (1, 2)
    and whole (``fault.elastic_restore``)."""
    grids = torch.stack([lattice.init_grid(threefry.PRNGKey(s), 16, 32, 3,
                                           0.1, device="cpu")
                         for s in range(3)])
    lat = sharded.place(grids, LatticeMesh((("cpu", "cpu"),
                                            ("cpu", "cpu"))))
    cm = CheckpointManager(str(tmp_path), device="cpu")
    cm.save(3, {"lattice": lat, "key": threefry.PRNGKey(9)})
    meta = json.load(open(os.path.join(str(tmp_path), "step_0000000003",
                                       "manifest.json")))["leaves"]
    assert meta["lattice"]["n_shards"] == 4
    assert meta["lattice"]["bounds"]["3"] == [[0, 3], [8, 16], [16, 32]]
    for shape in ((4, 1), (1, 2)):
        mesh = LatticeMesh(tuple(tuple(torch.device("cpu")
                                       for _ in range(shape[1]))
                                 for _ in range(shape[0])))
        _, got = fault.elastic_restore(cm, {"lattice": mesh})
        assert isinstance(got["lattice"], sharded.ShardedLattice)
        assert got["lattice"].mesh.shape == shape
        assert torch.equal(got["lattice"].gather(), grids)
        assert torch.equal(got["key"], threefry.PRNGKey(9))
    _, whole = cm.restore()
    assert torch.equal(whole["lattice"], grids)


def test_sharded_checkpoints_cross_with_jax_meshes(tmp_path, subproc):
    """4 fake JAX devices: a lattice JAX saved sharded over a (2, 2) mesh
    restores onto a (2, 2) ``LatticeMesh`` of ``cpu`` block for block, and
    a ``ShardedLattice`` the port saved restores whole in JAX."""
    out = subproc(f"""
        import json, numpy as np, jax, torch
        from jax.sharding import NamedSharding, PartitionSpec as P
        from repro.runtime.checkpoint import CheckpointManager as J
        from repro_torch.core import sharded
        from repro_torch.parallel.sharding import LatticeMesh
        from repro_torch.runtime.checkpoint import CheckpointManager
        assert len(jax.devices()) == 4
        grid = np.arange(16 * 24, dtype=np.int32).reshape(16, 24) % 7
        mesh = jax.make_mesh((2, 2), ("rows", "cols"))
        arr = jax.device_put(grid, NamedSharding(mesh, P("rows", "cols")))
        J({str(tmp_path / 'j')!r}).save(1, {{"g": arr}})
        cpu = LatticeMesh(((torch.device("cpu"),) * 2,) * 2)
        _, got = CheckpointManager({str(tmp_path / 'j')!r},
                                   device="cpu").restore(
            shardings={{"g": cpu}})
        blocks = [b.numpy() for b in got["g"].flat]
        ok1 = all(np.array_equal(b, grid[r * 8:(r + 1) * 8,
                                         c * 12:(c + 1) * 12])
                  for b, (r, c) in zip(blocks, [(0, 0), (0, 1), (1, 0),
                                                (1, 1)]))
        lat = sharded.place(torch.from_numpy(grid.astype(np.int8)), cpu)
        CheckpointManager({str(tmp_path / 't')!r}, device="cpu").save(
            2, {{"g": lat}})
        _, back = J({str(tmp_path / 't')!r}).restore()
        ok2 = (np.asarray(back["g"]).dtype == np.int8
               and np.array_equal(np.asarray(back["g"]), grid))
        print(json.dumps([ok1, ok2]))
    """, 4)
    assert json.loads(out.strip().splitlines()[-1]) == [True, True]

