"""The port's entry points: ``escg_run.py`` (the paper's CLI, one
simulation or ``--trials``) and ``serve.py`` (the scenario server,
DESIGN.md §12). Both run on the card unless ``--device cpu`` is given."""
