"""Replication of Zhong et al. (2022) Fig 2 (paper §3.1.2, Figs 3.2/3.3)
on the port, the twin of ``examples/zhong_ablated_rpsls.py``: ablated
RPSLS — remove Rock-crushes-Scissors and watch Paper go extinct within a
few hundred MCS, followed by the Rock-survival bifurcation.

    PYTHONPATH=src python -m repro_torch.examples.zhong_ablated_rpsls \\
        [--mcs 3000] [--device cpu]

The paper's long-run finding (Cliff 2025): the apparent steady state decays
at much longer horizons — push --mcs up to probe it.
"""
import argparse

from repro_torch.core import EngineConfig, RunConfig, dominance, io, metrics
from repro_torch.core import make_scenario, simulate

NAMES = {dominance.ROCK: "Rock", dominance.SCISSORS: "Scissors",
         dominance.LIZARD: "Lizard", dominance.PAPER: "Paper",
         dominance.SPOCK: "Spock"}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--L", type=int, default=100)
    ap.add_argument("--mcs", type=int, default=3000)
    ap.add_argument("--engine", type=str, default="batched")
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--device", type=str, default=None,
                    help="where to run: the card by default, 'cpu' for "
                         "the plain PyTorch path")
    args = ap.parse_args(argv)

    # the whole study is one registered scenario: physics (ablated
    # dominance network, mobility, S=5) come from the registry
    res = simulate(make_scenario("zhong_density"),
                   engine=EngineConfig(engine=args.engine),
                   run=RunConfig(length=args.L, height=args.L,
                                 mcs=args.mcs, chunk_mcs=500,
                                 seed=args.seed,
                                 out_dir="out/zhong"),
                   stop_on_stasis=False, device=args.device)

    print(f"L={args.L}, {args.mcs} MCS, engine={args.engine}")
    for sp in range(1, 6):
        ext = metrics.first_extinction_mcs(res.densities, sp)
        end = res.densities[-1][sp]
        status = f"extinct at MCS {ext}" if ext >= 0 else \
            f"alive (density {end:.3f})"
        print(f"  {NAMES[sp]:<9s} {status}")

    ext_paper = metrics.first_extinction_mcs(res.densities, dominance.PAPER)
    print(f"\nZhong et al. claim: Paper extinct within 200-600 MCS at "
          f"L=200 (faster for smaller L). Here: {ext_paper}.")
    io.export_densities_csv("out/zhong/densities.csv", res.densities)
    print("density trace -> out/zhong/densities.csv")


if __name__ == "__main__":
    main()
