"""The port's multi-device LM layer (``repro_torch.parallel.{sharding,ctx,
pipeline}``, ``launch.mesh``, the sharded train step, DTensor
checkpoints) against the JAX package's, on the CPU.

* Layouts: every config x both production meshes x every shape's rules,
  each leaf's fitted spec (params, optimizer state, caches) equal to the
  reference's ``fit_spec(partition_tree(...))`` on an ``AbstractMesh``
  (no devices, no process group).
* The sharded step: one config per family at ``reduced()`` (and
  Adafactor on kimi-k2), two steps from the reference's state on a gloo
  ``(2, 2)`` mesh of four CPU processes under ``activation_sharding``,
  against the port's unsharded step and the reference's step jitted with
  the same ``in_shardings`` on a mesh of 4 fake CPU devices. Float32
  tolerances: losses and grad norms of both steps relative 1e-5; params
  within the updates' range (2 lr per step) everywhere, and within 2e-5
  + 2e-5 |p| for all but 1e-3 of each leaf's elements: AdamW's first
  update g / (|g| + 1e-8) turns a float32 rounding of a grad of 1e-6 or
  less into a change of order one (up to 2 lr), and those params move
  the second step's grads, where a grad that is a sum of cancelling
  terms can change by tens of percent. Sums over shards run in another
  order than on one device, so nothing here is bit for bit. ``torch.vmap``
  is wrapped in the workers to raise on a DTensor argument.
* ``constrain``; AdamW and Adafactor on a sharded leaf, in one group
  of leading-axis slices and in several; the pipeline, checkpoints
  across meshes and packages, and the meshes.

The process groups live in subprocesses (two gloo worlds of four ranks
and one JAX process with 8 fake devices, started together by one module
fixture); no pytest worker holds a group.
"""
import json
import os
import socket
import subprocess
import sys
import textwrap
import time

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ARCHS as JARCHS
from repro.configs import SHAPES as JSHAPES
from repro.configs.base import ShapeConfig as JShape
from repro.data import synthetic as jsyn
from repro.models import build_model as jbuild
from repro.models import spec as jspec
from repro.parallel import sharding as jsharding
from repro.runtime import train_lib as jtl
from repro_torch import convert
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.models import build_model, spec
from repro_torch.models.spec import tree_leaves
from repro_torch.parallel import ctx, sharding
from repro_torch.runtime import train_lib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")

MESHES = {"single_pod": ((16, 16), ("data", "model")),
          "multi_pod": ((2, 16, 16), ("pod", "data", "model"))}

# the sharded step's cases: one config per family, Adafactor on kimi-k2;
# split over two gloo worlds run at once
CASES = {"granite-3-8b": {}, "pixtral-12b": {}, "grok-1-314b": {},
         "kimi-k2-1t-a32b": {"optimizer": "adafactor"},
         "falcon-mamba-7b": {}, "zamba2-7b": {}, "whisper-small": {}}
WORLDS = (("granite-3-8b", "grok-1-314b", "kimi-k2-1t-a32b", "whisper-small"),
          ("pixtral-12b", "falcon-mamba-7b", "zamba2-7b"))
SEQ, BATCH = 32, 4
LR = 3e-4


def _nf():
    return jax.threefry_partitionable(False)


# ------------------------------- layouts ---------------------------------- #

def _trees(model, shape, jax_side: bool):
    """The spec trees a cell places: the train state, or the params (and
    the caches for decode)."""
    tl = jtl if jax_side else train_lib
    if shape.kind == "train":
        return {"state": tl.state_specs(model)}
    out = {"params": model.param_specs}
    if shape.kind == "decode":
        out["cache"] = model.cache_specs(shape.global_batch, shape.seq_len)
    return out


def _at(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


@pytest.mark.parametrize("shape_name", sorted(SHAPES))
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_layouts_match_reference(arch, mesh_name, shape_name):
    """Every leaf's fitted spec equals the reference's, and its DTensor
    placements shard exactly the dims the spec names."""
    sizes, names = MESHES[mesh_name]
    jmesh = AbstractMesh(sizes, names)
    tmesh = dict(zip(names, sizes))
    jcfg, tcfg = JARCHS[arch], ARCHS[arch]
    jm, tm = jbuild(jcfg), build_model(tcfg)
    jshape, tshape = JSHAPES[shape_name], SHAPES[shape_name]
    jrules = jsharding.make_rules(jmesh, dict(jcfg.rule_overrides),
                                  jshape.kind, jshape.global_batch)
    trules = sharding.make_rules(tmesh, dict(tcfg.rule_overrides),
                                 tshape.kind, tshape.global_batch)
    assert trules == jrules
    jtrees, ttrees = _trees(jm, jshape, True), _trees(tm, tshape, False)
    n = 0
    for name, jtree in jtrees.items():
        jparts = jspec.partition_tree(jtree, jrules)
        tfit = spec.partition_tree(ttrees[name], trules, tmesh)
        layouts = sharding.placements_tree(ttrees[name], tmesh, trules)
        tpaths = spec.tree_paths(ttrees[name])
        assert sorted(tpaths) == sorted(jspec.tree_paths(jtree))
        for path, s in jspec.tree_paths(jtree).items():
            want = tuple(jsharding.fit_spec(s.shape, _at(jparts, path),
                                            jmesh))
            got = _at(tfit, path)
            assert got == want, (name, path, got, want)
            lay = _at(layouts, path)
            assert lay.spec == got
            sharded = {p.dim for p in lay.placements if p.is_shard()}
            assert sharded == {d for d, a in enumerate(got) if a}, path
            n += 1
    assert n > 0


def test_partition_tree_without_a_mesh_is_the_rules():
    """``partition_tree`` without a mesh maps the logical axes through the
    rules, as the reference's does (no fitting)."""
    tree = {"w": spec.ParamSpec((24, 64), ("q_heads", "embed"))}
    rules = sharding.make_rules({"data": 16, "model": 16})
    assert spec.partition_tree(tree, rules) == {"w": ("model", "data")}
    assert spec.partition_tree(tree, rules, {"data": 16, "model": 16}) == {
        "w": (None, "data")}


@pytest.mark.parametrize("shape,axes,mesh,want", [
    ((4, 32, 64), ("act_batch", "act_seq", None), {"data": 2, "model": 2},
     ("data", "model", None)),
    ((3, 32, 64), ("act_batch", "act_seq", None), {"data": 2, "model": 2},
     (None, "model", None)),
    ((4, 30, 64), ("act_batch", "act_seq", None), {"data": 2, "model": 4},
     ("data", None, None)),
    ((8, 32, 64), ("act_batch", "act_seq", None),
     {"pod": 2, "data": 2, "model": 2}, (("pod", "data"), "model", None)),
    ((2, 4, 8, 4, 16), ("act_batch", None, None, "experts", None),
     {"data": 2, "model": 2}, ("data", None, None, "model", None)),
])
def test_activation_spec_follows_the_rules(shape, axes, mesh, want):
    """``constrain``'s spec: each dim's rule, an axis that does not divide
    its dim dropped; its placements shard those dims."""
    rules = sharding.make_rules(mesh)
    got = ctx.activation_spec(shape, axes, mesh, rules)
    assert got == want
    pl = sharding.placements(got, mesh)
    assert len(pl) == len(mesh)


def test_constrain_without_context_is_the_identity():
    x = torch.ones(2, 3)
    assert ctx.constrain(x, "act_batch", None) is x
    assert ctx.constrain(None, "act_batch") is None
    with ctx.activation_sharding({"data": 2, "model": 2},
                                 sharding.make_rules({"data": 2,
                                                      "model": 2})):
        assert ctx.constrain(x, "act_batch", "act_seq") is x   # plain


def test_batch_and_scalar_placements():
    mesh = {"pod": 2, "data": 16, "model": 16}
    rules = sharding.make_rules(mesh, shape_kind="train", global_batch=256)
    pl = sharding.batch_sharding(mesh, rules)(2)
    assert [p.is_shard(0) for p in pl] == [True, True, False]
    assert all(p.is_replicate() for p in sharding.scalar_sharding(mesh))
    # one long sequence: the batch unsharded, the cache over both axes
    r1 = sharding.make_rules(mesh, shape_kind="decode", global_batch=1)
    assert r1["batch"] is None and r1["kv_seq"] == ("data", "model")


# ---------------------- the worlds (module fixture) ------------------------ #

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}|{k}" if prefix else k))
        return out
    return {prefix: np.asarray(tree)}


def _unflat(flat):
    root = {}
    for path, v in flat.items():
        d = root
        parts = path.split("|")
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return root


def _cfg(arch, jax_side):
    table = JARCHS if jax_side else ARCHS
    return table[arch].reduced().replace(**CASES[arch])


JAX_WORKER = r'''
import json, os, sys, time
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import ARCHS
from repro.models import build_model
from repro.parallel.ctx import activation_sharding
from repro.parallel.pipeline import pipeline_apply
from repro.parallel.sharding import make_rules, named_sharding_tree
from repro.runtime import train_lib
from repro.runtime.checkpoint import CheckpointManager
from repro.runtime.fault import elastic_restore

work, cases = sys.argv[1], json.loads(sys.argv[2])
devs = np.asarray(jax.devices())

def unflat(flat):
    root = {}
    for path, v in flat.items():
        d = root
        parts = path.split("|")
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return root

def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}|{k}" if prefix else k))
        return out
    return {prefix: np.asarray(tree)}

# the reference test's checkpoint on a (4, 2) mesh, written first
mesh8 = Mesh(devs[:8].reshape(4, 2), ("data", "model"))
x = jnp.arange(64, dtype=jnp.float32).reshape(8, 8)
r = jnp.arange(96, dtype=jnp.float32).reshape(16, 6) / 7
cm = CheckpointManager(os.path.join(work, "jax_ckpt"))
cm.save(3, {"w": jax.device_put(x, NamedSharding(mesh8, P("data", "model"))),
            "r": jax.device_put(r, NamedSharding(mesh8, P("data", None)))})

# the reference pipeline on 4 fake devices
pz = np.load(os.path.join(work, "pipe_in.npz"))
smesh = Mesh(devs[:4], ("stage",))
def block(p, h):
    return h + jax.nn.gelu(h @ p["w1"]) @ p["w2"]
params = {"w1": jnp.asarray(pz["w1"]), "w2": jnp.asarray(pz["w2"])}
outs = {f"n{n}": np.asarray(pipeline_apply(block, params,
                                           jnp.asarray(pz["x"]), n, smesh))
        for n in (4, 1)}
np.savez(os.path.join(work, "pipe_jax.npz"), **outs)

# the sharded steps, jitted with in_shardings on a (2, 2) mesh
mesh = Mesh(devs[:4].reshape(2, 2), ("data", "model"))
for arch, over in cases.items():
    cfg = ARCHS[arch].reduced().replace(**over)
    model = build_model(cfg)
    data = unflat(dict(np.load(os.path.join(work, f"in_{arch}.npz"))))
    rules = make_rules(mesh, dict(cfg.rule_overrides), "train",
                       data["batch"]["tokens"].shape[0])
    state_sh = named_sharding_tree(train_lib.state_specs(model), mesh, rules)
    batch_sh = {k: NamedSharding(mesh, P(*((rules["batch"],)
                                           + (None,) * (v.ndim - 1))))
                for k, v in data["batch"].items()}
    with mesh, activation_sharding(mesh, rules):
        step = jax.jit(train_lib.make_train_step(model),
                       in_shardings=(state_sh, batch_sh),
                       out_shardings=(state_sh, None))
        state = jax.device_put(jax.tree.map(jnp.asarray, data["state"]),
                               state_sh)
        batch = jax.device_put(jax.tree.map(jnp.asarray, data["batch"]),
                               batch_sh)
        mets = []
        for _ in range(2):
            state, m = step(state, batch)
            mets.append([float(m["loss"]), float(m["grad_norm"])])
    out = flat({"params": state["params"], "opt": state["opt"]})
    out["metrics"] = np.asarray(mets)
    np.savez(os.path.join(work, f"jax_{arch}.npz"), **out)
    print("JAX_STEP", arch, flush=True)

# the port's checkpoint (saved on a gloo (2, 2) mesh) restored here
ready = os.path.join(work, "port_ckpt", "step_0000000007", "COMMITTED")
t0 = time.time()
while not os.path.exists(ready):
    if time.time() - t0 > 600:
        raise SystemExit("the port's checkpoint never came")
    time.sleep(0.5)
want = unflat(dict(np.load(os.path.join(work, "in_granite-3-8b.npz"))))
emb = NamedSharding(mesh8, P("model", "data"))
step, got = elastic_restore(
    CheckpointManager(os.path.join(work, "port_ckpt")),
    {"state": {"params": {"embed": {"tokens": emb}}}})
assert step == 7
np.testing.assert_array_equal(
    np.asarray(got["state"]["params"]["embed"]["tokens"]),
    want["state"]["params"]["embed"]["tokens"])
assert len(got["state"]["params"]["embed"]["tokens"].sharding.device_set) == 8
for a, b in zip(jax.tree.leaves(got["state"]), jax.tree.leaves(want["state"])):
    np.testing.assert_array_equal(np.asarray(a), b)
print("JAX_RESTORED_PORT", flush=True)
'''


PORT_WORKER = r'''
import json, os, sys, time
import numpy as np, torch, torch.distributed as dist
rank, world, port, work, cases = (int(sys.argv[1]), int(sys.argv[2]),
                                  sys.argv[3], sys.argv[4],
                                  json.loads(sys.argv[5]))
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=world)
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
from torch.utils._pytree import tree_leaves as leaves_any
from repro_torch import convert
from repro_torch.configs import ARCHS
from repro_torch.models import build_model
from repro_torch.models.spec import tree_leaves, tree_map
from repro_torch.parallel import ctx
from repro_torch.parallel.sharding import make_rules, distribute_batch
from repro_torch.runtime import train_lib
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.fault import elastic_restore

real_vmap = torch.vmap
def guarded_vmap(fn, *a, **k):
    inner = real_vmap(fn, *a, **k)
    def call(*args, **kw):
        if any(isinstance(t, DTensor) for t in leaves_any((args, kw))):
            raise AssertionError("a DTensor leaf went through torch.vmap")
        return inner(*args, **kw)
    return call
torch.vmap = guarded_vmap

def unflat(flat):
    root = {}
    for path, v in flat.items():
        d = root
        parts = path.split("|")
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return root

def whole(t):
    return t.full_tensor() if isinstance(t, DTensor) else t

mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
report = {}
if "constrain" in cases:
    rules = make_rules(mesh, None, "train", 4)
    x = torch.arange(4 * 8 * 6, dtype=torch.float32).reshape(4, 8, 6)
    dx = distribute_tensor(x, mesh, [Replicate(), Replicate()])
    odd = distribute_tensor(x[:3], mesh, [Replicate(), Replicate()])
    with ctx.activation_sharding(mesh, rules):
        y = ctx.constrain(dx, "act_batch", "act_seq", None)
        z = ctx.constrain(odd, "act_batch", "act_seq", None)
        again = ctx.constrain(y, "act_batch", "act_seq", None)
    report["constrain"] = {
        "y": [str(p) for p in y.placements],
        "z": [str(p) for p in z.placements],
        "y_equal": bool(torch.equal(whole(y), x)),
        "z_equal": bool(torch.equal(whole(z), x[:3])),
        "same_object": again is y}
    cases = {k: v for k, v in cases.items() if k != "constrain"}
if "optim" in cases:
    # both optimizers on a (3, 4, 8) leaf split over both mesh dims, its
    # grad in another layout, in one group and in groups of 2 + 1 slices
    from repro_torch.optim import optimizers
    gen = torch.Generator().manual_seed(0)
    def rnd(*shape):
        return torch.rand(*shape, generator=gen)
    p, g = rnd(3, 4, 8) - 0.5, rnd(3, 4, 8) - 0.5
    pl = (Shard(1), Shard(2))
    rep = (Replicate(), Replicate())
    def put(t, pls):
        return distribute_tensor(t, mesh, pls)
    lr, step = torch.tensor(0.01), torch.tensor(3, dtype=torch.int32)
    report["optim"] = {}
    for elems in (64, 1 << 24):
        optimizers._SLICE_ELEMS = elems
        for name in ("adamw", "adafactor"):
            if name == "adamw":
                st = {"m": rnd(3, 4, 8), "v": rnd(3, 4, 8)}
                dst = {k: put(v, pl) for k, v in st.items()}
            else:
                st = {"vr": rnd(3, 4), "vc": rnd(3, 8)}
                dst = {"vr": put(st["vr"], (Shard(1), Replicate())),
                       "vc": put(st["vc"], (Replicate(), Shard(1)))}
            opt = getattr(optimizers, name)()
            wp, ws = opt.apply({"w": p}, {"w": g}, {"w": st}, lr, step)
            gp, gs = opt.apply({"w": put(p, pl)},
                               {"w": put(g, (Replicate(), Shard(1)))},
                               {"w": dst}, put(lr, rep), put(step, rep))
            report["optim"][f"{name}_{elems}"] = {
                "param_err": float((whole(gp["w"]) - wp["w"]).abs().max()),
                "state_err": max(float((whole(gs["w"][k]) - ws["w"][k])
                                       .abs().max()) for k in st),
                "placed": tuple(gp["w"].placements) == pl and all(
                    tuple(gs["w"][k].placements) == tuple(dst[k].placements)
                    for k in st)}
    optimizers._SLICE_ELEMS = 1 << 24
    cases = {k: v for k, v in cases.items() if k != "optim"}

placed_granite = None
for arch, over in cases.items():
    cfg = ARCHS[arch].reduced().replace(**over)
    model = build_model(cfg)
    data = unflat(dict(np.load(os.path.join(work, f"in_{arch}.npz"))))
    plain = convert.state_from_jax(data["state"], "cpu")
    batch = convert.state_from_jax(data["batch"], "cpu")
    rules = make_rules(mesh, dict(cfg.rule_overrides), "train",
                       batch["tokens"].shape[0])
    state = train_lib.place_state(model, plain, mesh, rules)
    if arch == "granite-3-8b":
        placed_granite = state
    before = [tuple(t.placements) for t in tree_leaves(state)]
    dbatch = distribute_batch(batch, mesh, rules)
    step = train_lib.make_train_step(model)
    mets = []
    t0 = time.time()
    for _ in range(2):
        with ctx.activation_sharding(mesh, rules):
            state, m = step(state, dbatch)
        mets.append([float(whole(m["loss"])), float(whole(m["grad_norm"]))])
    after = [tuple(t.placements) for t in tree_leaves(state)]
    assert after == before, arch
    flat = {}
    def walk(tree, prefix):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{prefix}|{k}")
        else:
            flat[prefix] = convert.state_to_numpy(whole(tree))
    walk(state["params"], "params")
    flat["metrics"] = np.asarray(mets)
    if rank == 0:
        np.savez(os.path.join(work, f"port_{arch}.npz"), **flat)
        print("PORT_STEP", arch, round(time.time() - t0, 1), flush=True)

if placed_granite is not None:
    # the int8 error-feedback residuals placed with the state: one step
    # with compression, sharded against unsharded
    model = build_model(ARCHS["granite-3-8b"].reduced())
    data = unflat(dict(np.load(os.path.join(work, "in_granite-3-8b.npz"))))
    plain = convert.state_from_jax(data["state"], "cpu")
    plain["ef"] = tree_map(lambda t: torch.zeros_like(t, dtype=torch.bfloat16),
                           plain["params"])
    batch = convert.state_from_jax(data["batch"], "cpu")
    rules = make_rules(mesh, None, "train", batch["tokens"].shape[0])
    cstep = train_lib.make_train_step(model, compress=True)
    placed = train_lib.place_state(model, plain, mesh, rules, compress=True)
    with ctx.activation_sharding(mesh, rules):
        got, gm = cstep(placed, distribute_batch(batch, mesh, rules))
    want, wm = cstep(plain, batch)
    errs = [float((whole(a).float() - b.float()).abs().max())
            for a, b in zip(tree_leaves(got), tree_leaves(want))]
    report["ef"] = {"leaves": len(errs), "max_err": max(errs),
                    "placed": all(isinstance(t, DTensor)
                                  for t in tree_leaves(got["ef"])),
                    "loss": [float(whole(gm["loss"])), float(wm["loss"])]}
    # a DTensor state saved from (2, 2), every rank writing its shards
    cm = CheckpointManager(os.path.join(work, "port_ckpt"), device="cpu")
    cm.save(7, {"state": placed_granite}, blocking=False)
    cm.wait()
    want = unflat(dict(np.load(os.path.join(work, "in_granite-3-8b.npz"))))
    flat_want = tree_leaves(convert.state_from_jax(want["state"], "cpu"))
    mesh4 = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
    def onto(m, n):
        return tree_map(lambda t: (m, (Shard(0),) if t.ndim and
                                   t.shape[0] % n == 0 else (Replicate(),)),
                        placed_granite)
    step, got = elastic_restore(cm, {"state": onto(mesh4, 4)})
    ok4 = step == 7 and all(
        isinstance(a, DTensor) and a.device_mesh is mesh4
        and torch.equal(whole(a), b)
        for a, b in zip(tree_leaves(got["state"]), flat_want))
    # the reference's (4, 2) checkpoint onto this (2, 2) mesh
    ready = os.path.join(work, "jax_ckpt", "step_0000000003", "COMMITTED")
    t0 = time.time()
    while not os.path.exists(ready):
        assert time.time() - t0 < 600
        time.sleep(0.5)
    jstep, jgot = elastic_restore(
        CheckpointManager(os.path.join(work, "jax_ckpt"), device="cpu"),
        {"w": (mesh, (Shard(0), Shard(1))),
         "r": (mesh, (Shard(0), Replicate()))})
    okj = (jstep == 3 and tuple(jgot["w"].to_local().shape) == (4, 4)
           and torch.equal(whole(jgot["w"]),
                           torch.arange(64.).reshape(8, 8))
           and torch.equal(whole(jgot["r"]),
                           torch.arange(96.).reshape(16, 6) / 7))
    dist.barrier()
    dist.destroy_process_group()
    report["ckpt"] = {"onto_4": bool(ok4), "jax_onto_2x2": bool(okj)}
    if rank == 0:
        # a world of one: the same checkpoint onto (1,) and onto one device
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
        mesh1 = init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
        _, got1 = cm.restore(7, {"state": onto(mesh1, 1)})
        report["ckpt"]["onto_1"] = all(
            isinstance(a, DTensor) and torch.equal(whole(a), b)
            for a, b in zip(tree_leaves(got1["state"]), flat_want))
        _, got0 = cm.restore(7)
        report["ckpt"]["onto_device"] = all(
            type(a) is torch.Tensor and torch.equal(a, b)
            for a, b in zip(tree_leaves(got0["state"]), flat_want))
        dist.destroy_process_group()
else:
    dist.destroy_process_group()
if rank == 0:
    with open(os.path.join(work, f"report_{world}_{port}.json"), "w") as f:
        json.dump(report, f)
    print("PORT_DONE", flush=True)
'''


def _write(tmp, name, text):
    path = os.path.join(tmp, name)
    with open(path, "w") as f:
        f.write(textwrap.dedent(text))
    return path


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Inputs from the reference, then the JAX process and both gloo
    worlds at once; returns the work directory and each process's
    output."""
    work = str(tmp_path_factory.mktemp("parallel"))
    for arch in CASES:
        jm = jbuild(_cfg(arch, True))
        with _nf():
            state = jtl.init_state(jm, jax.random.PRNGKey(0))
            batch = jsyn.batch_for_model(jm, JShape("t", SEQ, BATCH,
                                                    "train"), 0, 1)
        np.savez(os.path.join(work, f"in_{arch}.npz"),
                 **_flat({"state": state, "batch": batch}))
    k = jax.random.PRNGKey(0)
    np.savez(os.path.join(work, "pipe_in.npz"),
             w1=np.asarray(jax.random.normal(k, (4, 16, 32)) * 0.1),
             w2=np.asarray(jax.random.normal(jax.random.fold_in(k, 1),
                                             (4, 32, 16)) * 0.1),
             x=np.asarray(jax.random.normal(jax.random.fold_in(k, 2),
                                            (8, 16))))
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    jenv = dict(env, JAX_PLATFORMS="cpu",
                XLA_FLAGS="--xla_force_host_platform_device_count=8 "
                          "--xla_cpu_multi_thread_eigen=false")
    jscript = _write(work, "jax_worker.py", JAX_WORKER)
    pscript = _write(work, "port_worker.py", PORT_WORKER)
    procs = {"jax": subprocess.Popen(
        [sys.executable, jscript, work,
         json.dumps({a: CASES[a] for a in CASES})],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=jenv)}
    for w, archs in enumerate(WORLDS):
        cases = {a: CASES[a] for a in archs}
        if w == 1:
            cases = {"constrain": {}, "optim": {}, **cases}
        port = _free_port()
        for rank in range(4):
            procs[f"port{w}.{rank}"] = subprocess.Popen(
                [sys.executable, pscript, str(rank), "4", str(port), work,
                 json.dumps(cases)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                env=env)
    outs, deadline = {}, time.time() + 900
    for name, p in procs.items():
        try:
            outs[name] = p.communicate(
                timeout=max(1, deadline - time.time()))[0]
        except subprocess.TimeoutExpired:
            p.kill()
            outs[name] = p.communicate()[0] + "\nTIMEOUT"
        outs[name] += f"\nRC={p.returncode}"
    return work, outs


def _load(work, name):
    path = os.path.join(work, name)
    assert os.path.exists(path), f"{name} missing"
    return dict(np.load(path))


def _port_unsharded(work, arch):
    model = build_model(_cfg(arch, False))
    data = _unflat(dict(np.load(os.path.join(work, f"in_{arch}.npz"))))
    state = convert.state_from_jax(data["state"], "cpu")
    batch = convert.state_from_jax(data["batch"], "cpu")
    step = train_lib.make_train_step(model)
    mets = []
    for _ in range(2):
        state, m = step(state, batch)
        mets.append([float(m["loss"]), float(m["grad_norm"])])
    flat = _flat({"params": convert.state_to_numpy(state["params"])})
    flat["metrics"] = np.asarray(mets)
    return flat


def _hold(want, got, what):
    """Metrics relative 1e-5; params by the module's tolerance."""
    np.testing.assert_allclose(got["metrics"], want["metrics"], rtol=1e-5,
                               err_msg=what)
    keys = sorted(k for k in want if k.startswith("params|"))
    assert keys == sorted(k for k in got if k.startswith("params|"))
    for k in keys:
        a, b = want[k].astype(np.float32), got[k].astype(np.float32)
        err = np.abs(a - b)
        assert (err <= 2 * 2 * LR).all(), (what, k, float(err.max()))
        far = int((err > 2e-5 + 2e-5 * np.abs(a)).sum())
        assert far <= 1e-3 * a.size, (what, k, far, a.size)


@pytest.mark.parametrize("arch", list(CASES))
def test_sharded_step_equals_unsharded_and_reference(worlds, arch):
    """Two steps on a gloo (2, 2) mesh equal the port's unsharded steps
    and the reference's steps jitted on a (2, 2) mesh of fake devices."""
    work, outs = worlds
    log = "\n".join(f"--- {k}\n{v[-3000:]}" for k, v in outs.items()
                    if "RC=0" not in v)
    assert os.path.exists(os.path.join(work, f"port_{arch}.npz")), log
    port = _load(work, f"port_{arch}.npz")
    ref = _load(work, f"jax_{arch}.npz")
    plain = _port_unsharded(work, arch)
    _hold(plain, port, f"{arch}: sharded vs unsharded")
    _hold(ref, port, f"{arch}: port vs reference sharded")
    assert np.isfinite(port["metrics"]).all()


def test_workers_ran_clean(worlds):
    """Every process of the fixture exited 0 (the vmap guard included)."""
    _, outs = worlds
    bad = {k: v[-3000:] for k, v in outs.items() if "RC=0" not in v}
    assert not bad, bad
    assert outs["jax"].count("JAX_STEP") == len(CASES)
    assert "JAX_RESTORED_PORT" in outs["jax"]


def test_constrain_on_a_gloo_mesh(worlds):
    """Under a context the placements follow the rules: (4, 8, 6) as
    ('act_batch', 'act_seq', None) is Shard(0) x Shard(1); a batch of 3
    stays whole over 'data'; a tensor already laid out comes back as the
    same object."""
    work, outs = worlds
    rep = [json.load(open(os.path.join(work, f)))
           for f in os.listdir(work) if f.startswith("report_")]
    c = [r["constrain"] for r in rep if "constrain" in r]
    assert c, outs
    c = c[0]
    assert c["y"] == ["S(0)", "S(1)"] or c["y"] == ["Shard(dim=0)",
                                                    "Shard(dim=1)"]
    assert c["z"] in (["R", "S(1)"], ["Replicate()", "Shard(dim=1)"])
    assert c["y_equal"] and c["z_equal"] and c["same_object"]


@pytest.mark.parametrize("elems", [64, 1 << 24])
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_on_sharded_leaves(worlds, name, elems):
    """AdamW and Adafactor on a (3, 4, 8) DTensor leaf split over both
    dims of the gloo (2, 2) mesh (its grad in another layout), in one
    group of slices and in groups of 2 + 1 (``_SLICE_ELEMS`` 64), against
    the same update of the whole tensors: AdamW bit for bit (element-wise
    on the same values), Adafactor within 1e-6 (its means over sharded
    dims sum in another order; 1.2e-07 read here); the results keep
    their inputs' placements."""
    work, outs = worlds
    rep = [json.load(open(os.path.join(work, f)))
           for f in os.listdir(work) if f.startswith("report_")]
    o = [r["optim"] for r in rep if "optim" in r]
    assert o, outs
    got = o[0][f"{name}_{elems}"]
    assert got["placed"], got
    tol = 0.0 if name == "adamw" else 1e-6
    assert got["param_err"] <= tol and got["state_err"] <= tol, got


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_in_groups_of_slices_matches_reference(monkeypatch, name):
    """With ``_SLICE_ELEMS`` 64 a (3, 4, 8) leaf is updated in groups of
    2 + 1 slices, each group by one call: equal to the reference's
    per-slice ``lax.map`` update within 1e-5 (params) and 1e-6 (state),
    and AdamW bit for bit to the one-group update."""
    from repro.models import spec as jspec_mod
    from repro.optim import optimizers as jopt
    from repro_torch.optim import optimizers
    rs = np.random.default_rng(0)
    p, g = (rs.standard_normal((3, 4, 8)).astype(np.float32)
            for _ in range(2))
    jo = getattr(jopt, name)()
    to = getattr(optimizers, name)()
    st_specs = jo.state_specs({"w": jspec_mod.ParamSpec((3, 4, 8),
                                                        (None,) * 3)})
    st = jax.tree.map(lambda s: np.abs(rs.standard_normal(s.shape))
                      .astype(np.float32) * 0.01, st_specs,
                      is_leaf=jspec_mod.is_spec)
    jp, js = jo.apply({"w": p}, {"w": g}, st, np.float32(0.01),
                      np.int32(3))
    tst = jax.tree.map(torch.from_numpy, st)
    args = ({"w": torch.from_numpy(p)}, {"w": torch.from_numpy(g)}, tst,
            torch.tensor(0.01), torch.tensor(3, dtype=torch.int32))
    whole_p, _ = to.apply(*args)
    monkeypatch.setattr(optimizers, "_SLICE_ELEMS", 64)
    tp, ts = to.apply(*args)
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                               rtol=1e-5, atol=1e-5)
    for k in ts["w"]:
        np.testing.assert_allclose(ts["w"][k].numpy(),
                                   np.asarray(js["w"][k]), rtol=1e-6,
                                   atol=1e-6)
    if name == "adamw":
        assert torch.equal(tp["w"], whole_p["w"])


def test_error_feedback_residuals_on_a_mesh(worlds):
    """``place_state(compress=True)`` lays the int8 error-feedback
    residuals out with the params as DTensors; one compressed step on the
    gloo (2, 2) mesh equals the unsharded one: every state leaf within the
    update's range, 2 lr (an ill-conditioned first AdamW update; 7.6e-06
    read here), the loss within 1e-6 relative."""
    work, outs = worlds
    rep = [json.load(open(os.path.join(work, f)))
           for f in os.listdir(work) if f.startswith("report_")]
    ef = [r["ef"] for r in rep if "ef" in r]
    assert ef, outs
    ef = ef[0]
    assert ef["placed"] and ef["leaves"] > 0
    assert ef["max_err"] <= 2 * LR, ef
    a, b = ef["loss"]
    assert abs(a - b) <= 1e-6 * abs(b)


@pytest.mark.parametrize("onto", ["onto_4", "onto_1", "onto_device",
                                  "jax_onto_2x2"])
def test_checkpoint_across_meshes_and_packages(worlds, onto):
    """A state saved from a gloo (2, 2) mesh (each rank its own shards,
    rank 0 the manifest) restores onto (4,), onto (1,) and onto one
    device, equal; the reference's (4, 2) checkpoint restores onto (2, 2)
    through ``elastic_restore``; the reference restores the port's
    (``test_workers_ran_clean``: JAX_RESTORED_PORT)."""
    work, outs = worlds
    rep = [json.load(open(os.path.join(work, f)))
           for f in os.listdir(work) if f.startswith("report_")]
    c = [r["ckpt"] for r in rep if "ckpt" in r]
    assert c, outs
    assert c[0][onto] is True
    manifest = json.load(open(os.path.join(
        work, "port_ckpt", "step_0000000007", "manifest.json")))
    leaf = manifest["leaves"]["state/params/embed/tokens"]
    assert leaf["n_shards"] == 4 and len(leaf["bounds"]) == 4


# ------------------------------- pipeline --------------------------------- #

def _block(p, h):
    """The reference test's block; ``jax.nn.gelu`` is the tanh form."""
    return h + torch.nn.functional.gelu(h @ p["w1"],
                                        approximate="tanh") @ p["w2"]


@pytest.mark.parametrize("n_micro", [4, 1])
def test_pipeline_matches_sequential_and_reference(worlds, n_micro):
    """GPipe over 4 stages on ``["cpu"] * 4``: per micro-batch bit for bit
    the sequential composition, within 1e-5 of the whole batch and of the
    reference's ``pipeline_apply`` on 4 fake devices (the reference test's
    block and weights)."""
    from repro_torch.parallel.pipeline import pipeline_apply
    work, _ = worlds
    pz = np.load(os.path.join(work, "pipe_in.npz"))
    w1, w2 = torch.from_numpy(pz["w1"]), torch.from_numpy(pz["w2"])
    x = torch.from_numpy(pz["x"])
    got = pipeline_apply(_block, {"w1": w1, "w2": w2}, x, n_micro,
                         ["cpu"] * 4)
    per_micro = []
    for xm in x.reshape(n_micro, -1, 16):
        h = xm
        for i in range(4):
            h = _block({"w1": w1[i], "w2": w2[i]}, h)
        per_micro.append(h)
    assert torch.equal(got, torch.cat(per_micro))
    whole = x
    for i in range(4):
        whole = _block({"w1": w1[i], "w2": w2[i]}, whole)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), atol=1e-5,
                               rtol=1e-5)
    ref = _load(work, "pipe_jax.npz")[f"n{n_micro}"]
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_pipeline_rejects_a_batch_n_micro_does_not_divide():
    from repro_torch.parallel.pipeline import pipeline_apply
    p = {"w1": torch.zeros(2, 4, 4), "w2": torch.zeros(2, 4, 4)}
    with pytest.raises(ValueError, match="n_micro"):
        pipeline_apply(_block, p, torch.zeros(6, 4), 4, ["cpu"] * 2)
    with pytest.raises(ValueError, match="leading dim"):
        pipeline_apply(_block, p, torch.zeros(8, 4), 4, ["cpu"] * 3)


def test_split_stages():
    from repro_torch.parallel.pipeline import split_stages
    t = split_stages({"w": torch.arange(24.).reshape(8, 3)}, 4)
    assert tuple(t["w"].shape) == (4, 2, 3)
    with pytest.raises(ValueError):
        split_stages({"w": torch.zeros(6, 3)}, 4)


# -------------------------------- meshes ---------------------------------- #

def test_make_composed_mesh_axes():
    """``launch.mesh`` builds the ('pod', 'rows', 'cols') layout the
    ``sharded_pod`` engine uses, with or without the lattice checks (the
    reference's test, on one CPU device)."""
    from repro_torch.launch.mesh import make_composed_mesh, n_chips
    m = make_composed_mesh((1, 1, 1), devices="cpu")
    assert m.axis_names == ("pod", "rows", "cols")
    m2 = make_composed_mesh((1, 1, 1), height=16, width=16, tile=(8, 8),
                            devices="cpu")
    assert m2.shape == (1, 1, 1) and n_chips(m2) == 1
    with pytest.raises(ValueError):
        make_composed_mesh((1, 1, 2), height=16, width=16, tile=(8, 16),
                           devices="cpu")
    m4 = make_composed_mesh(None, devices=["cpu"] * 4)
    assert m4.shape == (4, 1, 1) and n_chips(m4) == 4


def test_make_mesh_needs_a_group_and_a_card():
    import torch.distributed as dist
    from repro_torch.launch import mesh
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        mesh.make_mesh((2, 2), ("data", "model"), device_type="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            mesh.make_production_mesh()
    with pytest.raises(ValueError):
        mesh.make_mesh((2, 2), ("data",), device_type="cpu")
