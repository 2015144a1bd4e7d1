"""K4's and K4s's time per call through their Python wrappers, the host's
share of a launch included.

    python3 src/repro_torch/kernels/probe/k4_launch.py [--src DIR]
        [--repeats R] [--calls N]

Imports ``repro_torch`` from ``DIR`` (default: the ``src`` of the checkout
that holds this file), so that two trees of the package can be timed one
after the other in one call on one card, and builds that tree's kernels.
On the shapes of ``chip_smoke.py``'s main path (park3 at 3200 x 3200,
int32, labels 0..3) it makes, R times (default 5):

* N (default 200) back-to-back calls of ``density_counts`` of the lattice
  (K4, which ``pallas_fused``, ``pallas`` and ``batched`` call once per
  MCS), and the same of ``density_counts_sharded`` of its four 1600 x 1600
  blocks on one card (K4s, the ``sharded`` engine's count on a (2, 2)
  mesh);
* for each, the ms per call by CUDA events around the N calls (the
  larger of the host's and the device's time per call), and the host's
  us per call, the wall of the N calls before the card is waited for.

It prints one JSON object with the card's name and power limit. It needs
a card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

SIDE = 3200


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(here, "..", "..", ".."))
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--calls", type=int, default=200)
    args = ap.parse_args()
    src = os.path.abspath(args.src)
    sys.path.insert(0, src)
    import torch
    if not torch.cuda.is_available():
        print("k4_launch: no CUDA card", file=sys.stderr)
        return 2
    from repro_torch.core import lattice, threefry
    from repro_torch.kernels import build, density

    build.build(["density"])
    dev = torch.device("cuda")
    grid = lattice.init_grid(threefry.PRNGKey(0), SIDE, SIDE, 3, 0.1,
                             dtype=torch.int32, device=dev)
    half = SIDE // 2
    blocks = [grid[r:r + half, c:c + half].contiguous()
              for r in (0, half) for c in (0, half)]
    cases = {"density_counts": lambda: density.density_counts(grid, 3),
             "density_counts_sharded":
                 lambda: density.density_counts_sharded(blocks, 3)}
    want = torch.bincount(grid.reshape(-1).long(), minlength=4).int()
    result = {}
    for name, fn in cases.items():
        if not torch.equal(fn(), want):
            raise AssertionError(f"{name} differs from torch.bincount")
        event_ms, host_us = [], []
        for _ in range(args.repeats):
            fn()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            for _ in range(args.calls):
                fn()
            host_us.append((time.perf_counter() - t0) / args.calls * 1e6)
            stop.record()
            torch.cuda.synchronize()
            event_ms.append(start.elapsed_time(stop) / args.calls)
        result[name] = {"event_ms_per_call": event_ms,
                        "host_us_per_call": host_us}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"src": args.src, "card": card, "calls": args.calls,
                      **result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
