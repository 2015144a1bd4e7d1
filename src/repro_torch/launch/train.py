"""[LM-scaffold appendix — NOT an ESCG entry point; DESIGN.md §9.]

End-to-end LM training driver of the port (port of
``repro.launch.train``), retained from the quarantined LM-framework
scaffold: synthetic pipeline, AdamW/Adafactor, checkpoint/restart fault
tolerance, optional int8-EF gradient compression. The ESCG entry points
are ``escg_run`` (repro_torch.launch.escg_run) and ``escg_serve``
(repro_torch.launch.serve); nothing in the ESCG reproduction imports this
module. ``--arch`` takes every config in ``configs/`` (every model
family: dense, vlm, moe, ssm, hybrid, encdec); a config's optimizer is
its own (kimi-k2: Adafactor).

It runs on the card; ``--device cpu`` runs the plain PyTorch path.
Without a card and without ``--device cpu`` it exits non-zero.

Example (trains a ~100M-param granite-family model):
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-8b \
      --reduced --d_model 512 --layers 12 --steps 300 --batch 8 --seq 256
"""
from __future__ import annotations

import argparse
import os
import time

from ..configs import get_arch
from ..configs.base import ShapeConfig
from ..core import threefry
from ..core.device import resolve_device
from ..data.synthetic import batch_for_model
from ..models.registry import build_model
from ..optim import cosine_schedule
from ..runtime import train_lib
from ..runtime.checkpoint import CheckpointManager
from ..runtime.fault import (FaultTolerantLoop, Heartbeat,
                             StragglerMonitor)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="LM-scaffold appendix driver (DESIGN.md §9) — not an "
                    "ESCG entry point; use escg_run / escg_serve for the "
                    "reproduction")
    ap.add_argument("--arch", type=str, default="granite-3-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--d_model", type=int, default=0)
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--heads", type=int, default=0)
    ap.add_argument("--vocab", type=int, default=0)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt_dir", type=str, default="ckpt_train")
    ap.add_argument("--ckpt_every", type=int, default=100)
    ap.add_argument("--compress", action="store_true",
                    help="int8 error-feedback gradient compression")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log_every", type=int, default=10)
    ap.add_argument("--device", type=str, default=None,
                    help="where to run: the card by default, 'cpu' for "
                         "the plain PyTorch path")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    kw = {}
    if args.d_model:
        kw.update(d_model=args.d_model,
                  head_dim=args.d_model // max(1, (args.heads or 8)))
    if args.layers:
        kw["n_layers"] = args.layers
    if args.heads:
        kw.update(n_heads=args.heads, n_kv=max(1, args.heads // 2))
    if args.vocab:
        kw["vocab"] = args.vocab
    if kw:
        cfg = cfg.replace(**kw)
    model = build_model(cfg)
    print(f"[train] arch={cfg.name} params={model.n_params():,} "
          f"(active {model.n_active_params():,}) device={dev}")

    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    schedule = cosine_schedule(args.lr, warmup=min(100, args.steps // 10),
                               total=args.steps)

    step_fn = train_lib.make_train_step(model, schedule=schedule,
                                        compress=args.compress)

    ckpt = CheckpointManager(args.ckpt_dir, keep=3, device=dev)
    state = None
    start = 0
    if args.resume and ckpt.latest_step() is not None:
        start, state = ckpt.restore()
        print(f"[train] resumed from step {start}")
    if state is None:
        state = train_lib.init_state(model, threefry.PRNGKey(args.seed),
                                     compress=args.compress, device=dev)

    losses = []

    def on_metrics(step, m):
        losses.append(float(m["loss"]))
        if step % args.log_every == 0:
            print(f"[train] step {step:5d} loss {float(m['loss']):.4f} "
                  f"gnorm {float(m['grad_norm']):.3f} "
                  f"lr {float(m['lr']):.2e}", flush=True)

    loop = FaultTolerantLoop(
        step_fn, ckpt, ckpt_every=args.ckpt_every,
        straggler=StragglerMonitor(),
        heartbeat=Heartbeat(os.path.join(args.ckpt_dir, "heartbeat"),
                            interval_s=10.0))
    t0 = time.time()
    state, end = loop.run(
        state, lambda s: batch_for_model(model, shape, s, args.seed,
                                         device=dev),
        args.steps, start_step=start, on_metrics=on_metrics)
    dt = time.time() - t0
    if not losses:
        print(f"[train] done: nothing to run, the checkpoint is at step "
              f"{start} of {args.steps}")
        return
    print(f"[train] done: steps {start}->{end} in {dt:.1f}s "
          f"({(end - start) / max(dt, 1e-9):.2f} steps/s); "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")


if __name__ == "__main__":
    main()
