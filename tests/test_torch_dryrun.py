"""The port's roofline terms and multi-pod dry-run
(``repro_torch.parallel.roofline``, ``repro_torch.launch.dryrun``) on the
CPU, and the guard that the multi-device modules import neither ``jax``
nor ``repro``.

One subprocess, with ``jax`` and ``repro`` blocked, imports
``parallel.ctx``, ``.pipeline``, ``.roofline``, ``launch.mesh`` and
``.dryrun``, counts collectives and a product under fake process groups,
checks ``make_production_mesh``'s names and sizes at 256 and 512 ranks,
and runs the reference's mini dry-run (``tests/test_parallel_scaffold.py``):
granite-3-8b and zamba2-7b at ``reduced()``, 4 layers, ``attn_every`` 2,
a (64-token, batch 4) train step on a (2, 2) fake group. Its records'
useful-FLOPs ratio (6·N·tokens per chip over the counted local FLOPs)
must lie in [0.5, 0.95]: the layer remat recomputes each forward (6/8 of
the FLOPs at most are model FLOPs), attention and the one-hot embedding
add their own.

Three more subprocesses, one per family (hybrid zamba2-7b, Mamba-1
falcon-mamba-7b, dense granite-3-8b), each at ``reduced()`` with 2
layers, trace a (16-token, batch 4) train step on a (2, 2) ``data x
model`` fake group and on a (2, 2, 2) ``pod x data x model`` one: the
second pod must halve each chip's work, as the production meshes'
records do (FLOPs at most 0.55 of one pod's, local ops at most 1.5
times). DTensor's own plans for the SSM products, with the batch and the
weights' rows split over ('pod', 'data'), gathered and split the same
rows over and over (the multi-pod SSM traces ran 10 to 40 times longer)
and computed more rows than each chip's own.
"""
import json
import os
import subprocess
import sys

import pytest

from repro_torch.launch import dryrun
from repro_torch.parallel import roofline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")

GUARDED = r'''
import json, sys
sys.modules["jax"] = None            # any import of jax now fails
sys.modules["repro"] = None          # and so does any of the JAX package
import repro_torch.parallel.ctx
import repro_torch.parallel.pipeline
import repro_torch.parallel.roofline as roofline
import repro_torch.launch.mesh as mesh
import repro_torch.launch.dryrun as dryrun
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig

out = {}
for world, multi in ((256, False), (512, True)):
    dryrun.init_fake_world(world)
    m = mesh.make_production_mesh(multi_pod=multi, device_type="cpu")
    out[f"mesh{world}"] = [list(m.mesh_dim_names), list(m.shape),
                           mesh.n_chips(m)]
    if world == 256:
        # the trap: per-chip FLOPs of a product of DTensors are the local
        # product's, (4, 256) @ (256, 32), not the global (64, 256, 512)
        a = DTensor.from_local(torch.empty(4, 256, device="meta"), m,
                               [Shard(0), Replicate()], run_check=False)
        b = DTensor.from_local(torch.empty(256, 32, device="meta"), m,
                               [Replicate(), Shard(1)], run_check=False)
        with roofline.LocalCost() as c:
            y = a @ b
        out["product_flops"] = c.flops
        out["product_shape"] = [list(y.shape), list(y.to_local().shape)]

dryrun.init_fake_world(4)
grp = dist.group.WORLD
x = torch.ones(8, 16)                      # 512 bytes per rank
with roofline.collective_bytes() as cb:
    g = funcol.all_gather_tensor(x, 0, grp)
    r = funcol.reduce_scatter_tensor(torch.ones(32, 16), "sum", 0, grp)
    torch.add(g, 0), torch.add(r, 0)
out["coll"] = cb.by_kind
out["coll_calls"] = cb.calls

m = mesh.make_mesh((2, 2), ("data", "model"), device_type="cpu")
recs = {}
for arch in ("granite-3-8b", "zamba2-7b"):
    cfg = get_arch(arch).reduced().replace(n_layers=4, attn_every=2)
    over = {k: getattr(cfg, k) for k in cfg.__dataclass_fields__
            if k != "name"}
    recs[arch] = dryrun.lower_lm_cell(arch, ShapeConfig("t", 64, 4, "train"),
                                      False, cfg_overrides=over, mesh=m)
out["records"] = recs
bad = sorted(k for k in sys.modules
             if sys.modules[k] is not None
             and (k == "jax" or k.startswith(("jax.", "jaxlib", "repro."))))
out["bad_modules"] = bad
print("GUARDED_JSON " + json.dumps(out))
'''


POD_CELL = r'''
import json, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import repro_torch.launch.mesh as mesh
import repro_torch.launch.dryrun as dryrun
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig

arch = sys.argv[1]
cfg = get_arch(arch).reduced().replace(n_layers=2)
if cfg.family == "hybrid":
    cfg = cfg.replace(attn_every=2)
over = {k: getattr(cfg, k) for k in cfg.__dataclass_fields__ if k != "name"}
out = {}
for shape, axes in (((2, 2), ("data", "model")),
                    ((2, 2, 2), ("pod", "data", "model"))):
    dryrun.init_fake_world(2 ** len(shape))
    m = mesh.make_mesh(shape, axes, device_type="cpu")
    rec = dryrun.lower_lm_cell(arch, ShapeConfig("t", 16, 4, "train"),
                               len(shape) == 3, cfg_overrides=over, mesh=m)
    out[len(shape)] = [rec["cost"]["flops"], rec["cost"]["local_ops"]]
print("POD_JSON " + json.dumps(out))
'''
POD_ARCHS = ("zamba2-7b", "falcon-mamba-7b", "granite-3-8b")


def _run_all(scripts):
    """Run each (code, args) at once in a subprocess with ``src`` on the
    path; returns each one's stdout."""
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen([sys.executable, "-c", code, *args],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for code, args in scripts]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, out[-3000:] + err[-3000:]
        outs.append(out)
    return outs


def _json_line(out, tag):
    line = [ln for ln in out.splitlines() if ln.startswith(tag + " ")]
    assert line, out[-3000:]
    return json.loads(line[-1][len(tag) + 1:])


@pytest.fixture(scope="module")
def traced():
    outs = _run_all([(GUARDED, ())] + [(POD_CELL, (a,)) for a in POD_ARCHS])
    return {"guarded": _json_line(outs[0], "GUARDED_JSON"),
            "pods": {a: _json_line(o, "POD_JSON")
                     for a, o in zip(POD_ARCHS, outs[1:])}}


@pytest.fixture(scope="module")
def guarded(traced):
    return traced["guarded"]


@pytest.mark.parametrize("arch", POD_ARCHS)
def test_a_second_pod_halves_each_chips_work(traced, arch):
    """Per chip, two pods do at most 0.55 of one pod's FLOPs (half, with
    the replicated embedding and norms) and at most 1.5 times its local
    ops."""
    (one_flops, one_ops), (two_flops, two_ops) = (
        traced["pods"][arch]["2"], traced["pods"][arch]["3"])
    assert two_flops <= 0.55 * one_flops, (one_flops, two_flops)
    assert two_ops <= 1.5 * one_ops, (one_ops, two_ops)


def test_multi_device_modules_import_neither_jax_nor_repro(guarded):
    assert guarded["bad_modules"] == []


def test_production_meshes_under_a_fake_group(guarded):
    assert guarded["mesh256"] == [["data", "model"], [16, 16], 256]
    assert guarded["mesh512"] == [["pod", "data", "model"], [2, 16, 16],
                                  512]


def test_local_flops_of_a_sharded_product(guarded):
    """Counted below DTensor: the local (4, 256) @ (256, 32) product,
    2·4·256·32 FLOPs, not the global 2·64·256·512."""
    assert guarded["product_shape"] == [[64, 512], [4, 32]]
    assert guarded["product_flops"] == 2 * 4 * 256 * 32


def test_collective_counter(guarded):
    """An all-gather of 512 bytes per rank over 4 ranks outputs 2048
    bytes; a reduce-scatter of 2048 bytes outputs 512; each with its
    group size."""
    coll = guarded["coll"]
    assert coll["all-gather"] == 4 * 8 * 16 * 4
    assert coll["reduce-scatter"] == 8 * 16 * 4
    assert coll["all-reduce"] == 0
    assert sorted(c[0] for c in guarded["coll_calls"]) == [
        "all-gather", "reduce-scatter"]
    assert all(c[2] == 4 for c in guarded["coll_calls"])


@pytest.mark.parametrize("arch", ["granite-3-8b", "zamba2-7b"])
def test_mini_dryrun_records(guarded, arch):
    rec = guarded["records"][arch]
    assert rec["status"] == "ok" and rec["chips"] == 4
    rl = rec["roofline"]
    assert rl["flops_per_chip"] > 0 and rl["bytes_per_chip"] > 0
    assert 0.5 <= rl["useful_flops_ratio"] <= 0.95, rl["useful_flops_ratio"]
    assert rl["dominant"] in ("compute", "memory", "collective")
    mem = rec["memory"]
    assert 0 < mem["argument_size_in_bytes"] <= mem["peak_live_bytes"]
    assert sum(rl["collective_breakdown"].values()) > 0
    # along one mesh dim (2 ranks), and the loss's mean and the grad norm
    # each one all-reduce over the whole mesh (4)
    assert rec["collectives"]["group_sizes"] == [2, 4]


def test_roofline_terms_by_hand():
    t = roofline.roofline_terms(989.4e12, 3.35e12 / 2, 256 * 25e9, 256)
    assert t["compute_s"] == pytest.approx(1.0)
    assert t["memory_s"] == pytest.approx(0.5)
    assert t["collective_s"] == pytest.approx(0.5)
    assert t["dominant"] == "compute" and t["bound_s"] == pytest.approx(1.0)
    t = roofline.roofline_terms(0, 0, 512 * 100e9, 512)
    assert t["dominant"] == "collective"
    assert t["collective_s"] == pytest.approx(2.0)
    assert roofline.model_flops(8_000_000_000, 1_048_576) == \
        6.0 * 8e9 * 1_048_576
    assert roofline.model_flops(10, 7, "serve") == 140.0
    s = roofline.summarize({"flops": 4e12, "bytes accessed": 1e9},
                           {"all-gather": 10}, 4, 1000, 100, "train")
    assert s["collective_bytes"] == 40
    assert s["useful_flops_ratio"] == pytest.approx(6e5 / 4 / 4e12)


def test_escg_cell_equals_a_hand_count():
    """256² on (16, 16), tile (8, 8): blocks of 16², 4 tiles of 64
    proposals each; K3's table reads and writes the block (2·1024 B), 16 B
    per proposal, one trial's shift (8 B); 38 operations per update; the
    halo's right, bottom and corner slabs (16·8 + 8·16 + 8·8 cells)."""
    rec = dryrun.lower_escg_cell(False, lattice=256, tile=(8, 8))
    assert rec["cost"]["bytes"] == 2 * 16 * 16 * 4 + 16 * 256 + 8
    assert rec["cost"]["operations"] == 256 * 38
    halo = (16 * 8 + 8 * 16 + 8 * 8) * 4
    rl = rec["roofline"]
    assert rl["collective_breakdown"]["collective-permute"] == halo
    assert rl["collective_bytes"] == halo * 256
    assert rl["collective_s"] == pytest.approx(halo / roofline.LINK_BW)
    assert rl["compute_s"] == pytest.approx(256 * 38 / roofline.INSTR_RATE)
    assert rl["updates_per_round"] == 256 * 256
    mp = dryrun.lower_escg_cell(True, lattice=256, tile=(8, 8))
    assert mp["trials"] == 2 and mp["chips"] == 512
    assert mp["roofline"]["updates_per_round"] == 2 * 256 * 256
    with pytest.raises(ValueError):
        dryrun.lower_escg_cell(False, lattice=200, tile=(8, 8))


def test_summary_table(tmp_path):
    """``--summary`` prints one row per cell, its one-pod and two-pod
    values side by side; a cell that did not trace shows its reason."""
    for multi in (False, True):
        rec = dryrun.lower_escg_cell(multi, lattice=256, tile=(8, 8))
        (tmp_path / f"e{multi}.json").write_text(json.dumps(rec))
    (tmp_path / "b.json").write_text(json.dumps(
        {"arch": "x", "shape": "s", "mesh": "single_pod",
         "status": "error", "error": "boom"}))
    rows = dryrun.summary(str(tmp_path)).splitlines()
    assert len(rows) == 4
    assert rows[2].startswith("| escg-lattice L256_tile8x8 | ")
    assert "| collective / collective |" in rows[2]
    assert rows[3].startswith("| x s | error: boom / — |")
    assert dryrun.main(["--summary", "--out", str(tmp_path)]) == 0
