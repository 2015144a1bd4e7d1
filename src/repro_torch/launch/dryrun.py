"""Multi-pod dry-run (port of ``repro.launch.dryrun``): every arch x shape
cell's train, prefill or decode step on the production meshes, traced
without a card, with its per-chip cost and roofline terms.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape train_4k --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch escg

``main`` sets up a fake process group (``torch.distributed``'s ``fake``
backend over a ``FakeStore``) of 256 or 512 ranks in this one process,
rank 0 of it; the step then runs on ``meta`` tensors placed as DTensors
by the rules, so it allocates nothing and its collectives move nothing.
This is a dry-run by design, as the reference's lowering on 512 fake XLA
devices is: no number in its records was timed.

Per cell (``lower_lm_cell``) the record holds rank 0's counts, taken
below DTensor's dispatch (``parallel.roofline.LocalCost``): the FLOPs
and bytes of the local ops (each op's operands and outputs, an unfused
upper bound), the collectives' output bytes by kind, the exact local
bytes of the placed arguments, and the peak of live bytes while the step
ran (the arguments plus every local output until it is freed; the old
state is not donated, so the peak holds both states at the end). Under
DTensor a ``FlopCounterMode`` would count each op at its global shape.
The port's layer loop runs every layer, so the reference's
``loop_corrected_cost`` (XLA counts a while-loop body once) has no
counterpart: the counts are of every layer.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any, Dict, Optional

import numpy as np

from ..configs import ARCHS, SHAPES, cell_is_runnable, get_arch
from ..parallel import roofline

ESCG_ARCH = "escg-lattice"       # the paper's own workload, dry-run as well
LOOP_NOTE = ("every layer of the Python loop counted (no while-loop "
             "correction needed)")
BYTES_NOTE = ("operands + outputs of every local op: an unfused upper "
              "bound")


def init_fake_world(world: int) -> None:
    """A fake process group of ``world`` ranks in this process (rank 0):
    collectives return at once and move nothing. An initialized group of
    another size is destroyed first."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", rank=0, world_size=world,
                            store=FakeStore())


def _local_bytes(*trees) -> int:
    """Bytes this rank holds of the leaves of ``trees``: a DTensor's local
    shard, a plain tensor whole."""
    from torch.distributed.tensor import DTensor

    from ..models.spec import tree_leaves
    return sum((t.to_local() if isinstance(t, DTensor) else t).nbytes
               for tree in trees for t in tree_leaves(tree))


def trace_cell(cfg, shape, mesh, rules) -> Dict[str, Any]:
    """Run one cell's step on ``meta`` DTensors over ``mesh`` under the
    rules and ``LocalCost``. Returns rank 0's counts and ``n_tokens``."""
    from ..models import build_model
    from ..models import spec as spec_mod
    from ..parallel.ctx import activation_sharding
    from ..parallel.sharding import distribute_batch, distribute_tree
    from ..runtime import train_lib

    model = build_model(cfg)
    batch = distribute_batch(model.input_specs(shape), mesh, rules)
    if shape.kind == "train":
        specs = train_lib.state_specs(model)
        args = (distribute_tree(spec_mod.abstract(specs), specs, mesh,
                                rules), batch)
        fn = train_lib.make_train_step(model)
        n_tokens = shape.global_batch * shape.seq_len
    elif shape.kind == "prefill":
        args = (distribute_tree(model.abstract_params(), model.param_specs,
                                mesh, rules), batch)
        fn = train_lib.make_prefill_step(model, max_len=shape.seq_len)
        n_tokens = shape.global_batch * shape.seq_len
    else:                                       # decode
        cspecs = model.cache_specs(shape.global_batch, shape.seq_len)
        args = (distribute_tree(model.abstract_params(), model.param_specs,
                                mesh, rules),
                distribute_tree(spec_mod.abstract(cspecs), cspecs, mesh,
                                rules), batch)
        fn = train_lib.make_decode_step(model)
        n_tokens = shape.global_batch           # one token per sequence
    arg_bytes = _local_bytes(*args)
    cost = roofline.LocalCost(base_bytes=arg_bytes)
    with activation_sharding(mesh, rules), cost:
        out = fn(*args)
    del out
    return {"model": model, "n_tokens": n_tokens, "arg_bytes": arg_bytes,
            "cost": cost}


def lower_lm_cell(arch: str, shape_name: str, multi_pod: bool,
                  rule_overrides: Optional[Dict[str, Any]] = None,
                  cfg_overrides: Optional[Dict[str, Any]] = None,
                  mesh=None) -> Dict[str, Any]:
    """Trace one (arch x shape x mesh) cell; return the record. ``mesh``
    defaults to the production mesh over the initialized (fake) group."""
    from ..parallel.sharding import make_rules
    from .mesh import make_production_mesh, n_chips

    cfg = get_arch(arch)
    if cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    mesh_name = "multi_pod" if multi_pod else "single_pod"
    ok, why = cell_is_runnable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape.name, "mesh": mesh_name,
                "status": "skipped", "reason": why}
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    chips = n_chips(mesh)
    overrides = dict(cfg.rule_overrides)
    if rule_overrides:
        overrides.update(rule_overrides)
    rules = make_rules(mesh, overrides, shape.kind, shape.global_batch)

    t0 = time.time()
    traced = trace_cell(cfg, shape, mesh, rules)
    elapsed = time.time() - t0
    cost, model = traced["cost"], traced["model"]
    kind = "train" if shape.kind == "train" else "serve"
    terms = roofline.summarize(
        {"flops": cost.flops, "bytes accessed": cost.bytes},
        cost.by_kind, chips, model.n_active_params(), traced["n_tokens"],
        kind)
    return {
        "arch": arch, "shape": shape.name, "mesh": mesh_name,
        "chips": chips, "status": "ok",
        "trace_s": round(elapsed, 1),
        "n_params": model.n_params(),
        "n_active_params": model.n_active_params(),
        "n_tokens": traced["n_tokens"],
        "memory": {"argument_size_in_bytes": traced["arg_bytes"],
                   "peak_live_bytes": cost.peak_bytes,
                   "total_bytes_per_device": cost.peak_bytes},
        "cost": {"flops": cost.flops, "bytes": cost.bytes,
                 "local_ops": cost.ops, "note": BYTES_NOTE,
                 "loop": LOOP_NOTE},
        "collectives": {"calls": len(cost.calls),
                        "group_sizes": sorted({g for _, _, g in cost.calls})},
        "hardware": roofline.HARDWARE,
        "roofline": terms,
    }


# ESCG: per elementary update of K3's table form, the instructions it
# needs at the least (chip_smoke.py's OPS_PER_STREAM_UPDATE), and the
# bytes of its proposal (4 fields of 4 bytes)
OPS_PER_STREAM_UPDATE = 38
PROPOSAL_BYTES = 16


def lower_escg_cell(multi_pod: bool, lattice: int = 16384,
                    tile=(8, 128), species: int = 5,
                    cell_bytes: int = 4) -> Dict[str, Any]:
    """Count one MCS round of the port's ``sharded_pod`` engine with the
    stream-fed K3 table on the production layout, without running it:
    the lattice split over ('data', 'model') as (rows, cols), one trial
    on the (16, 16) mesh, a trial per pod on (2, 16, 16) (the reference's
    cell). Per device: K3's table bytes (the halo-extended block read and
    the block written, each update's proposal, the trial's shift) and
    operations by PERF.md's bound formulas; as collective bytes, the halo
    slabs ``core/sharded.py::halo_extend`` copies in from the neighbours
    (a ``collective-permute`` in the reference's terms). Needs no process
    group."""
    from .mesh import PRODUCTION_SHAPES

    shape, axes = PRODUCTION_SHAPES[bool(multi_pod)]
    sizes = dict(zip(axes, shape))
    chips = int(np.prod(shape))
    th, tw = tile
    n_trials = sizes.get("pod", 1)
    dr, dc = sizes["data"], sizes["model"]
    h = w = lattice
    if h % dr or (h // dr) % th or w % dc or (w // dc) % tw:
        raise ValueError(f"({dr}, {dc}) blocks of {lattice}^2 are not "
                         f"unions of {tile} tiles")
    bh, bw = h // dr, w // dc
    tiles_per_block = (bh // th) * (bw // tw)
    k_per = th * tw                       # proposals per tile and MCS
    n_dev = 1                             # trials on each device
    updates = n_dev * tiles_per_block * k_per
    block_bytes = bh * bw * cell_bytes
    n_bytes = (2 * n_dev * block_bytes + PROPOSAL_BYTES * updates
               + 8 * n_dev)
    n_ops = updates * OPS_PER_STREAM_UPDATE
    halo = n_dev * ((bh * tw if dc > 1 else 0) + (th * bw if dr > 1 else 0)
                    + (th * tw if dr > 1 and dc > 1 else 0)) * cell_bytes
    coll = {k: 0 for k in roofline.COLLECTIVE_OPS}
    coll["collective-permute"] = halo
    terms = roofline.roofline_terms(n_ops, n_bytes, halo * chips, chips,
                                    peak=roofline.INSTR_RATE)
    terms["collective_breakdown"] = coll
    terms["updates_per_round"] = n_trials * (h // th) * (w // tw) * k_per
    terms["updates_per_chip"] = updates
    return {
        "arch": ESCG_ARCH, "shape": f"L{lattice}_tile{th}x{tw}",
        "mesh": "multi_pod" if multi_pod else "single_pod",
        "chips": chips, "status": "ok", "trace_s": 0.0,
        "species": species, "trials": n_trials,
        "block": [bh, bw],
        "memory": {"argument_size_in_bytes": n_dev * block_bytes
                   + PROPOSAL_BYTES * updates,
                   "total_bytes_per_device": n_dev * (
                       block_bytes + (bh + (th if dr > 1 else 0))
                       * (bw + (tw if dc > 1 else 0)) * cell_bytes)
                   + PROPOSAL_BYTES * updates},
        "cost": {"operations": n_ops, "bytes": n_bytes,
                 "note": "counted by formula: K3 table + halo extension"},
        "hardware": roofline.HARDWARE,
        "roofline": terms,
    }


def summary(out_dir: str) -> str:
    """The records under ``out_dir`` as a markdown table, one row per cell
    with its single-pod and multi-pod values as "a / b": per-device GiB
    (the peak of live bytes), the three roofline terms in ms, the dominant
    one, the useful-FLOPs ratio and the seconds the trace took; a cell
    that did not trace shows its status and reason."""
    cells: Dict[Any, Dict[str, Any]] = {}
    for name in sorted(os.listdir(out_dir)):
        if name.endswith(".json"):
            with open(os.path.join(out_dir, name)) as f:
                rec = json.load(f)
            cells.setdefault((rec["arch"], rec["shape"]), {})[
                rec["mesh"]] = rec

    def value(rec, fn):
        if rec is None:
            return "—"
        if rec["status"] != "ok":
            why = rec.get("reason") or rec.get("error", "")
            return f"{rec['status']}: {why[:60]}"
        return fn(rec)

    cols = (
        ("GiB", lambda r:
         f"{r['memory']['total_bytes_per_device'] / 2 ** 30:.2f}"),
        ("compute ms", lambda r: f"{r['roofline']['compute_s'] * 1e3:.4g}"),
        ("memory ms", lambda r: f"{r['roofline']['memory_s'] * 1e3:.4g}"),
        ("collective ms",
         lambda r: f"{r['roofline']['collective_s'] * 1e3:.4g}"),
        ("dominant", lambda r: r["roofline"]["dominant"]),
        ("useful FLOPs", lambda r: (
            f"{r['roofline']['useful_flops_ratio']:.3f}"
            if "useful_flops_ratio" in r["roofline"] else "—")),
        ("trace s", lambda r: f"{r['trace_s']}"))
    rows = ["| cell (1 pod / 2 pods) | " + " | ".join(c for c, _ in cols)
            + " |", "| --- |" + " --- |" * len(cols)]
    for (arch, shape), by_mesh in sorted(cells.items()):
        one, two = by_mesh.get("single_pod"), by_mesh.get("multi_pod")
        rows.append(f"| {arch} {shape} | " + " | ".join(
            f"{value(one, fn)} / {value(two, fn)}" for _, fn in cols) + " |")
    return "\n".join(rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="multi-pod dry-run")
    ap.add_argument("--arch", type=str, default="all",
                    help="arch id, 'all', or 'escg'")
    ap.add_argument("--shape", type=str, default="all")
    ap.add_argument("--mesh", type=str, default="both",
                    choices=("single_pod", "multi_pod", "both"))
    ap.add_argument("--out", type=str, default="experiments/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--escg-lattice", type=int, default=16384)
    ap.add_argument("--summary", action="store_true",
                    help="print the records under --out as a table")
    args = ap.parse_args(argv)
    if args.summary:
        print(summary(args.out))
        return 0

    os.makedirs(args.out, exist_ok=True)
    archs = list(ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = (["single_pod", "multi_pod"] if args.mesh == "both"
              else [args.mesh])

    cells = []
    for mp in meshes:
        for arch in archs:
            if arch == "escg":
                cells.append((ESCG_ARCH, f"L{args.escg_lattice}", mp))
                continue
            for shape in shapes:
                cells.append((arch, shape, mp))

    n_ok = n_fail = n_skip = 0
    for arch, shape, mp in cells:
        tag = f"{arch}__{shape}__{mp}".replace("/", "_")
        path = os.path.join(args.out, tag + ".json")
        if os.path.exists(path) and not args.force:
            print(f"[dryrun] cached {tag}")
            continue
        print(f"[dryrun] tracing {tag} ...", flush=True)
        try:
            if arch == ESCG_ARCH:
                rec = lower_escg_cell(mp == "multi_pod",
                                      lattice=args.escg_lattice)
            else:
                init_fake_world(512 if mp == "multi_pod" else 256)
                rec = lower_lm_cell(arch, shape, mp == "multi_pod")
            status = rec["status"]
        except Exception as e:                              # noqa: BLE001
            rec = {"arch": arch, "shape": shape, "mesh": mp,
                   "status": "error", "error": str(e),
                   "traceback": traceback.format_exc()[-4000:]}
            status = "error"
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        if status == "ok":
            n_ok += 1
            mem = rec.get("memory", {}).get("total_bytes_per_device", 0)
            dom = rec.get("roofline", {}).get("dominant", "?")
            print(f"[dryrun]   ok {tag}: {mem/2**30:.2f} GiB/dev, "
                  f"dominant={dom}, trace={rec['trace_s']}s", flush=True)
        elif status == "skipped":
            n_skip += 1
            print(f"[dryrun]   skipped {tag}: {rec['reason']}")
        else:
            n_fail += 1
            print(f"[dryrun]   ERROR {tag}: {rec['error'][:300]}")
    print(f"[dryrun] done ok={n_ok} skip={n_skip} fail={n_fail}")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
