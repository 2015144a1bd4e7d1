"""Park, Chen & Szolnoki (2023) eight-species alliances (paper §4.3.2,
Figs 4.8-4.13) + the Cliff & Sinadjan mobility extension (Appendix C), on
the port: the twin of ``examples/park_alliances.py``.

    PYTHONPATH=src python -m repro_torch.examples.park_alliances \\
        --alpha 0.15 --beta 0.75 --L 48 --trials 8 [--device cpu]

Reports per-species survival probabilities and the survivor-count
histogram over IID trials run as one batch; with --mobility > 0 it
reproduces the companion paper's central claim that mobility changes the
phase behaviour.
"""
import argparse

from repro_torch.core.park import survival_probabilities


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--alpha", type=float, default=0.15)
    ap.add_argument("--beta", type=float, default=0.75)
    ap.add_argument("--gamma", type=float, default=1.0)
    ap.add_argument("--L", type=int, default=48)
    ap.add_argument("--trials", type=int, default=8)
    ap.add_argument("--mcs", type=int, default=0,
                    help="0 -> Park protocol (L^2)")
    ap.add_argument("--mobility", type=float, default=0.0,
                    help=">0 enables the companion-paper extension")
    ap.add_argument("--device", type=str, default=None,
                    help="where to run: the card by default, 'cpu' for "
                         "the plain PyTorch path")
    args = ap.parse_args(argv)

    mcs = args.mcs or args.L * args.L
    ps, hist = survival_probabilities(
        args.alpha, args.beta, args.gamma, L=args.L, n_trials=args.trials,
        mcs=mcs, mobility=args.mobility, device=args.device)

    tag = (f"alpha={args.alpha} beta={args.beta} gamma={args.gamma} "
           f"L={args.L} mcs={mcs} mobility={args.mobility}")
    print(f"Park alliances: {tag}")
    print("survival probability per species:")
    for i, p in enumerate(ps, start=1):
        bar = "#" * int(p * 40)
        print(f"  s{i}: {p:5.2f} {bar}")
    print("survivor-count histogram:",
          " ".join(f"{i}:{v:.2f}" for i, v in enumerate(hist) if v > 0))
    print(f"species-5 extinction probability: {1 - ps[4]:.3f} "
          f"(paper Fig 4.11-4.13 studies this across alpha)")
    if args.mobility > 0:
        print("mobility > 0: the companion paper shows this collapses "
              "Park et al.'s phase structure — compare against "
              "--mobility 0 at the same seed")


if __name__ == "__main__":
    main()
