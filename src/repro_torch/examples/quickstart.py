"""Quickstart: Reichenbach–Mobilia–Frey rock-paper-scissors spirals
(paper Fig 1.1) on the port, the twin of ``examples/quickstart.py``.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Runs a 128x128 three-species ESCG at low mobility via the scenario-first
API: physics from the registered ``park3`` preset, run control from a
``RunConfig``. The preset's declared observables stream through the
device ring, so the result carries an interface-length trace alongside
the densities. Prints density traces and an ASCII snapshot; saves the
lattice + densities under out/quickstart.
"""
import argparse

import numpy as np

from repro_torch.core import (EngineConfig, RunConfig, compose, io,
                              make_scenario, simulate)

GLYPHS = " RPS45678"


def ascii_lattice(grid: np.ndarray, step: int = 4) -> str:
    return "\n".join("".join(GLYPHS[v] for v in row[::step])
                     for row in grid[::step])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", type=str, default=None,
                    help="where to run: the card by default, 'cpu' for "
                         "the plain PyTorch path")
    args = ap.parse_args(argv)

    scenario = make_scenario("park3", empty=0.1)   # RMF spirals, S=3
    engine = EngineConfig(engine="batched")
    run = RunConfig(length=128, height=128, mcs=400, chunk_mcs=100,
                    seed=0, out_dir="out/quickstart")

    def report(mcs_done, grid, counts):
        dens = counts[-1] / counts[-1].sum()
        print(f"MCS {mcs_done:5d}  empty={dens[0]:.3f} "
              f"R={dens[1]:.3f} P={dens[2]:.3f} S={dens[3]:.3f}")

    result = simulate(scenario, engine=engine, run=run, hooks=[report],
                      device=args.device)
    print("\nFinal lattice (1:4 downsample):")
    print(ascii_lattice(result.grid))
    params = compose(scenario, engine, run)
    io.save_state(run.out_dir, params, result.grid,
                  result.mcs_completed, scenario.dominance())
    io.export_densities_csv(f"{run.out_dir}/densities.csv",
                            result.densities)
    print(f"\nsaved state + densities to {run.out_dir}/")
    assert (result.densities[-1][1:] > 0).all(), "coexistence expected"
    print("all three species coexist — RMF low-mobility regime replicated")
    # the preset's streamed observables: interface length tracks the
    # spiral-boundary density, computed on the device every MCS
    iface = result.observables["interface_length"][:, 0]
    print(f"interface length {iface[0]:.3f} -> {iface[-1]:.3f} "
          f"({len(iface)} MCS on-device trace)")


if __name__ == "__main__":
    main()
