"""The correctness check's control: the reference put in the program's
place and run in the precision below the configuration's (bfloat16 for
its float32 rule), held to the float32 reference by the same comparison
as a run of the program. Each seed's numbers have to exceed the limits.

    python3 -m escgbench.control --workload <cell> --seeds 1 2 3

runs at the cell's own size on the card (the sampled trials of each seed
through chunk 2) and prints one JSON line per seed. It imports nothing of
the program.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from escgbench import check, harness  # noqa: E402

PRECISION = {"float32": "bfloat16"}


def readings(name: str, seed: int, device, overrides=None,
             root: Path = ROOT) -> dict:
    cell = harness.load_cell(name, root, overrides)
    model = cell.model
    key = harness.run_key(seed)
    sample = check.draw(seed, cell.trials)
    lower = PRECISION[cell.config["rule_precision"]]
    outputs = check.ReferenceOutputs(model, cell.engine, key, sample,
                                     cell.chunk, 2, device, lower,
                                     cell.k_mcs)
    numbers, bad = check.compare(model, cell.engine, key, sample,
                                 cell.chunk, 2, outputs, device, cell.k_mcs)
    limits = check.limits()
    return {"workload": name, "seed": seed, "precision": lower,
            "numbers": numbers, "failed_lanes": bad,
            "fails": any(v > limits[k] for k, v in numbers.items())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("escgbench.control: no CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed,
                                  torch.device("cuda", 0))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
