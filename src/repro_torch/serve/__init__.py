"""The scenario server of the port (port of ``repro.serve``, DESIGN.md
§12): ``trials.run_trials``/``simulation.simulate`` as a resident service
answering many users' ``(scenario, lattice, mcs, trials)`` requests.

* :mod:`protocol` — ``SimRequest``/``SimResponse`` and the JSON wire
  format, the reference's field for field;
* :mod:`bucketing` — bucket keys and the admission queue that packs
  same-bucket requests into one trial batch;
* :mod:`cache` — the LRU cache of built engines and their chunks, with
  hit / miss / build accounting;
* :mod:`executor` — the packed batch executor: one device batch, many
  requests, each response bit-identical to the direct call;
* :mod:`server` — :class:`~repro_torch.serve.server.ScenarioServer`, the
  in-process handle, on the card unless given ``device="cpu"``;
* :mod:`httpd` — a stdlib ``http.server`` adapter;
* :mod:`loadgen` — JSONL trace replay and its report.
"""
from .protocol import SimRequest, SimResponse  # noqa: F401
from .server import ScenarioServer  # noqa: F401
