"""Twins of the repo's ``examples/`` on the port, one module each, run as
``python -m repro_torch.examples.<name>``: the same flags, defaults,
printed lines and output files, and ``--device`` (default: the card;
``cpu`` runs the plain PyTorch path)."""
