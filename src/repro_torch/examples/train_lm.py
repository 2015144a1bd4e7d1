"""Train a small LM end to end on the port with the full production path:
synthetic pipeline -> train step -> AdamW -> checkpoint/restart loop; the
twin of ``examples/train_lm.py``.

The default is a ~13M-parameter granite-family model that demonstrably
learns the synthetic structure (loss drops well below ln(vocab)). For the
~100M variant:

    PYTHONPATH=src python -m repro_torch.examples.train_lm --preset 100m \\
        --steps 300 [--device cpu]

Other flags go on to ``repro_torch.launch.train``.
"""
import argparse

from repro_torch.launch import train as train_cli

PRESETS = {
    "13m": ["--d_model", "256", "--layers", "8", "--heads", "8",
            "--vocab", "4096", "--batch", "8", "--seq", "128"],
    "100m": ["--d_model", "640", "--layers", "12", "--heads", "10",
             "--vocab", "16384", "--batch", "8", "--seq", "256"],
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=sorted(PRESETS), default="13m")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--device", type=str, default=None,
                    help="where to run: the card by default, 'cpu' for "
                         "the plain PyTorch path")
    args, rest = ap.parse_known_args(argv)

    dev = [] if args.device is None else ["--device", args.device]
    train_cli.main(["--arch", "granite-3-8b", "--reduced"]
                   + PRESETS[args.preset]
                   + ["--steps", str(args.steps), "--ckpt_dir",
                      "out/train_lm", "--ckpt_every", "100"] + dev + rest)


if __name__ == "__main__":
    main()
