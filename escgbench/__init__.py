"""The benchmark of the PyTorch and CUDA port (``repro_torch``): IID-trial
studies of ESCG lattices on one card. ``python3 -m escgbench.run
--workload <cell> --seed <n> --seconds <s> --trace <0|1>``; README.md
says how cells, configurations and metrics are added as files."""
