"""Carry the JAX package's state into the port.

The reference's state crosses as plain data, so this module needs neither
``jax`` nor ``repro``:

* configs as their JSON form (``EscgParams``, ``Scenario``,
  ``EngineConfig``, ``RunConfig`` — objects with ``to_json()`` or the JSON
  text itself), which both packages share field for field;
* a key as its ``uint32`` key data (``numpy.asarray(jax.random.key_data(k))``
  or a raw ``PRNGKey``);
* a lattice or a padded dominance matrix as a numpy array;
* a ``TrialResult`` as its JSON form;
* an LM's params or train state (``params_from_jax``,
  ``state_from_jax``) as a tree of numpy arrays, ``np.asarray`` of each
  leaf: bfloat16 as an ``ml_dtypes`` array or the ``'<V2'`` payload the
  reference's checkpoints hold; ``state_to_numpy`` the other way.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .core.device import DeviceLike, resolve_device
from .core.params import EscgParams
from .core.scenarios import EngineConfig, RunConfig, Scenario
from .core.sharded import ShardedLattice
from .core.threefry import MASK
from .core.trials import TrialResult
from .runtime.checkpoint import tensor_from_numpy

_CONFIGS = {cls.__name__: cls
            for cls in (EscgParams, Scenario, EngineConfig, RunConfig)}


def config_from_jax(obj, kind: Optional[str] = None):
    """The port's counterpart of a reference config object (or of its JSON
    text, with ``kind`` naming the class: 'EscgParams', 'Scenario',
    'EngineConfig' or 'RunConfig')."""
    if isinstance(obj, str):
        if kind is None:
            raise ValueError("JSON text needs kind= to say which config")
        text = obj
    else:
        kind = kind or type(obj).__name__
        text = obj.to_json()
    if kind not in _CONFIGS:
        raise ValueError(f"unknown config kind {kind!r}; have "
                         f"{tuple(_CONFIGS)}")
    return _CONFIGS[kind].from_json(text)


def key_from_jax(key_data) -> torch.Tensor:
    """A port key (int64 (2,) on the host) from uint32 key data."""
    data = np.asarray(key_data)
    if data.shape != (2,) or not np.issubdtype(data.dtype, np.integer):
        raise ValueError(f"key data must be two integers, got {data!r}")
    return torch.tensor([int(v) & MASK for v in data.tolist()],
                        dtype=torch.int64)


def trial_result_from_jax(res) -> TrialResult:
    """The port's ``TrialResult`` of a reference ``TrialResult`` (or of its
    JSON text): the same fields, the streamed observables included."""
    return TrialResult.from_json(res if isinstance(res, str)
                                 else res.to_json())


def key_to_numpy(key: torch.Tensor) -> np.ndarray:
    """A port key as the reference's uint32 key data."""
    return np.asarray([int(v) & MASK for v in key.tolist()], np.uint32)


def grid_from_jax(grid, device: Optional[DeviceLike] = None
                  ) -> torch.Tensor:
    """A lattice as a tensor of the same dtype on ``device`` (default: the
    card)."""
    arr = np.ascontiguousarray(np.asarray(grid))
    if arr.ndim != 2 or arr.dtype not in (np.int8, np.int16, np.int32):
        raise ValueError(f"a lattice is a 2-D int8/int16/int32 array, got "
                         f"{arr.dtype} {arr.shape}")
    return torch.from_numpy(arr.copy()).to(resolve_device(device))


def dom_from_jax(dom, device: Optional[DeviceLike] = None) -> torch.Tensor:
    """The padded (S+1, S+1) dominance matrix as float32 on ``device``."""
    arr = np.asarray(dom, dtype=np.float32)
    if arr.ndim != 2 or arr.shape[0] != arr.shape[1]:
        raise ValueError(f"dominance must be square, got {arr.shape}")
    return torch.from_numpy(arr.copy()).to(resolve_device(device))


def _tree_from_jax(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_from_jax(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree).to(device)


def params_from_jax(params, device: Optional[DeviceLike] = None):
    """An LM's params as the port's tensors on ``device`` (default: the
    card): the same tree of dicts, each numpy leaf copied in its dtype
    (bfloat16 from an ``ml_dtypes`` array or a 2-byte void payload)."""
    return _tree_from_jax(params, resolve_device(device))


def state_from_jax(state, device: Optional[DeviceLike] = None):
    """An LM train state (``params``, ``opt``, ``step`` [, ``ef``]) as the
    port's tensors on ``device`` (default: the card), leaf by leaf as
    ``params_from_jax``; the step stays a 0-d int32 tensor."""
    return _tree_from_jax(state, resolve_device(device))


def state_to_numpy(tree):
    """A tree of the port's tensors as numpy arrays on the host, bfloat16
    widened to float32 (exact) since numpy has no bfloat16; a decomposed
    lattice (``ShardedLattice``) gathered whole."""
    if isinstance(tree, dict):
        return {k: state_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, ShardedLattice):
        tree = tree.gather()
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy().copy()
