"""Result streams (port of ``repro.core.results``, DESIGN.md §11).

``simulate`` returns a ``SimResult`` and ``trials.run_trials`` a
``TrialResult``; both satisfy the structural :class:`RunResult`
protocol. ``STREAM_NAMES`` are the streaming observables registered in
``core/observables.py``, read from the registry each time.
"""
from __future__ import annotations

from typing import Dict, Mapping, Protocol, runtime_checkable

import numpy as np

__all__ = ["RunResult", "STREAM_NAMES", "encode_observables",
           "decode_observables"]


@runtime_checkable
class RunResult(Protocol):
    """What ``SimResult`` and ``TrialResult`` share: ``observables``
    (observable name -> host array), the MCS that ran, and a lossless
    JSON form."""

    @property
    def observables(self) -> Mapping[str, np.ndarray]: ...

    @property
    def mcs_completed(self) -> int: ...

    def to_json(self) -> str: ...


def __getattr__(name: str):
    if name == "STREAM_NAMES":
        from .observables import observable_names
        return observable_names()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def encode_observables(obs: Mapping[str, np.ndarray]) -> Dict[str, dict]:
    """JSON-encodable payload for an observables mapping: dtype + shape +
    flat data per stream (float64/int arrays round-trip exactly)."""
    out = {}
    for name, arr in obs.items():
        a = np.asarray(arr)
        out[name] = {"dtype": str(a.dtype), "shape": list(a.shape),
                     "data": a.reshape(-1).tolist()}
    return out


def decode_observables(payload: Mapping[str, dict]) -> Dict[str, np.ndarray]:
    """Inverse of :func:`encode_observables`."""
    return {name: np.asarray(d["data"], dtype=np.dtype(d["dtype"]))
            .reshape(tuple(d["shape"]))
            for name, d in payload.items()}
