"""A long ESCG run on the port with chunking, periodic checkpoints,
snapshot export, the stasis exit and crash-resume: the twin of
``examples/escg_longrun.py``.

    PYTHONPATH=src python -m repro_torch.examples.escg_longrun --mcs 5000
    PYTHONPATH=src python -m repro_torch.examples.escg_longrun --mcs 8000
    # the second resumes; add --device cpu to run without a card

A checkpoint holds no key, so a resumed run is keyed, as the reference's
is, by ``fold_in(PRNGKey(0), start_mcs)`` (the port's threefry).
"""
import argparse
import os
import time

import numpy as np

from repro_torch.core import EscgParams, dominance, io, scenarios, simulate
from repro_torch.core import threefry

OUT = "out/longrun"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--L", type=int, default=128)
    ap.add_argument("--mcs", type=int, default=5000)
    ap.add_argument("--engine", type=str, default="sublattice")
    ap.add_argument("--species", type=int, default=5)
    ap.add_argument("--device", type=str, default=None,
                    help="where to run: the card by default, 'cpu' for "
                         "the plain PyTorch path")
    args = ap.parse_args(argv)

    dom = dominance.circulant(args.species, (1, 2))
    start_mcs = 0
    grid0 = key = None
    if os.path.exists(os.path.join(OUT, "state.npz")):
        params, grid0, start_mcs, dom, key = io.load_state(OUT)
        print(f"[longrun] resuming at MCS {start_mcs}")
        params = params.replace(mcs=max(args.mcs - start_mcs, 0))
        if key is None:
            key = threefry.fold_in(threefry.PRNGKey(0), start_mcs)
    else:
        params = EscgParams(length=args.L, height=args.L,
                            species=args.species, mobility=1e-5,
                            mcs=args.mcs, chunk_mcs=500,
                            engine=args.engine,
                            tile=(8, 16), seed=3, out_dir=OUT)

    ckpt_state = {"last": start_mcs}

    def checkpoint_hook(mcs_done, grid, counts):
        total = start_mcs + mcs_done
        if total - ckpt_state["last"] >= 1000:
            io.save_state(OUT, params.replace(mcs=args.mcs),
                          io.to_host(grid), total, np.asarray(dom))
            io.save_snapshot(OUT, io.to_host(grid), total)
            ckpt_state["last"] = total
            print(f"[longrun] checkpoint @ MCS {total}")

    t0 = time.time()
    # scenario-first invocation: decompose the (possibly checkpoint-loaded)
    # flat params and keep the explicit dominance net
    sc, eng_cfg, run_cfg = scenarios.decompose(params)
    res = simulate(sc, dom, grid0=grid0, key=key,
                   hooks=[checkpoint_hook], engine=eng_cfg, run=run_cfg,
                   device=args.device)
    dt = time.time() - t0
    total = start_mcs + res.mcs_completed
    io.save_state(OUT, params.replace(mcs=args.mcs), res.grid, total,
                  np.asarray(dom))
    ups = res.mcs_completed * params.n_cells / max(dt, 1e-9)
    print(f"[longrun] MCS {start_mcs}->{total} in {dt:.1f}s "
          f"({ups/1e6:.2f} M elementary updates/s)")
    if res.stasis_mcs >= 0:
        print(f"[longrun] stasis at MCS {start_mcs + res.stasis_mcs}")
    print("[longrun] densities:", np.round(res.densities[-1], 4))


if __name__ == "__main__":
    main()
