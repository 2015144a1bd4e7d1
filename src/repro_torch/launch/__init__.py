"""The port's entry points: ``escg_run.py`` (the paper's CLI, one
simulation or ``--trials``) and ``serve.py`` (the scenario server,
DESIGN.md §12); and, for the LM-scaffold appendix (DESIGN.md §9, not an
ESCG entry point), ``train.py``. Each runs on the card unless ``--device
cpu`` is given."""
