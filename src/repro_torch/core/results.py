"""Result streams (port of ``repro.core.results``, DESIGN.md §11).

``densities`` is the only stream this port produces. ``STREAM_NAMES`` are
the streaming observables the reference registers
(``repro/core/observables.py``); the port knows their names so that it can
refuse them by name, and ports the pipeline later.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np

__all__ = ["STREAM_NAMES", "encode_observables", "decode_observables"]

STREAM_NAMES = ("densities", "interface_length", "cluster_size", "snapshot")


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
