"""Ambient activation-sharding context (port of ``repro.parallel.ctx``).

Models are mesh-agnostic; the launcher (train, dry-run) installs a (mesh,
rules) context and model code calls ``constrain(x, *logical_axes)`` at
activation boundaries (the layer loop's carry, the MoE dispatch).
Logical activation axes resolve through the same rules table as the
parameters:

    'act_batch' -> ('pod', 'data')    data parallel
    'act_seq'   -> 'model'            Megatron-style sequence parallelism

Where the reference emits ``with_sharding_constraint``, the port
redistributes a ``DTensor`` to the placements of the same spec. With no
context installed, or on a plain tensor (one device), ``constrain`` is
the identity and returns its argument itself.

The models' products with a weight (``local_linear``, ``local_einsum``,
``local_matmul``), their per-token loss (``local_rows``) and the MoE
aux loss's count (``bincount``) run on each rank's shards through
``local_map`` where DTensor's own op strategies fail or have none; on
plain tensors each is the plain op.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, Optional, Tuple

import torch

_state = threading.local()


def _current() -> Optional[Tuple[Any, Dict[str, Any]]]:
    return getattr(_state, "ctx", None)


@contextlib.contextmanager
def activation_sharding(mesh, rules: Dict[str, Any]):
    """Install (mesh, rules) for ``constrain`` on this thread. Inside it a
    plain tensor that meets a DTensor (a position index, a mask, a zero
    made in the model) counts as replicated on the mesh."""
    from torch.distributed.tensor.experimental import implicit_replication
    prev = _current()
    _state.ctx = (mesh, rules)
    try:
        with implicit_replication():
            yield
    finally:
        _state.ctx = prev


def activation_spec(shape, logical_axes, mesh, rules: Dict[str, Any]
                    ) -> tuple:
    """The reference's spec of a constrained activation: each dim's rule,
    the mesh axes an earlier dim used dropped from a tuple (a name already
    used drops the dim's sharding), and an axis whose size does not
    divide the dim dropped."""
    from .sharding import _axis_size
    spec = []
    used = set()
    for dim, name in zip(shape, logical_axes):
        axis = rules.get(name) if name else None
        if isinstance(axis, (tuple, list)):       # drop already-used axes
            axis = tuple(a for a in axis if a not in used) or None
            if axis is not None and len(axis) == 1:
                axis = axis[0]
        elif axis in used:
            axis = None
        if axis is not None and dim % _axis_size(mesh, axis) != 0:
            axis = None
        if axis is not None:
            used.update(axis if isinstance(axis, tuple) else (axis,))
        spec.append(axis)
    return tuple(spec)


def constrain(x, *logical_axes: Optional[str]):
    """``x`` redistributed to the placements of its logical axes under the
    installed rules, when a context is installed and ``x`` is a DTensor;
    otherwise ``x`` itself."""
    ctx = _current()
    if ctx is None or x is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    mesh, rules = ctx
    from .sharding import placements
    want = placements(activation_spec(x.shape, logical_axes, mesh, rules),
                      mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def like(x, ref):
    """``x`` redistributed to ``ref``'s placements when both are DTensors
    and they differ (a grad to its param's layout: the reduce-scatter of
    FSDP); otherwise ``x`` itself."""
    from torch.distributed.tensor import DTensor
    if not (isinstance(x, DTensor) and isinstance(ref, DTensor)):
        return x
    if tuple(x.placements) == tuple(ref.placements):
        return x
    return x.redistribute(ref.device_mesh, ref.placements)


def local_value(x):
    """A replicated DTensor's value as a plain tensor; anything else as
    it is."""
    from torch.distributed.tensor import DTensor
    return x.to_local() if isinstance(x, DTensor) else x


def whole_along(x, dim: int):
    """``x`` with no mesh dim splitting tensor dim ``dim`` (a DTensor's
    shards of it gathered once, before a loop that slices or indexes that
    dim: DTensor would gather the whole tensor for every slice);
    anything else as it is."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        return x
    want = tuple(Replicate() if p.is_shard(dim) else p for p in x.placements)
    if want == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def bincount(x, minlength: int = 0):
    """``torch.bincount`` of a 1-D tensor. DTensor has no sharding rule
    for it, so a DTensor counts each shard (``local_map``) and the shards'
    counts sum over the mesh dims the input is split on (Partial)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    if not isinstance(x, DTensor):
        return torch.bincount(x, minlength=minlength)
    from torch.distributed.tensor.experimental import local_map

    def count(t):
        if t.is_meta:          # a dry-run: no values, labels < minlength
            return torch.empty(minlength, dtype=torch.int64, device="meta")
        return torch.bincount(t, minlength=minlength)
    out = tuple(Partial() if p.is_shard() else Replicate()
                for p in x.placements)
    return local_map(count,
                     out_placements=(out,), in_placements=(x.placements,),
                     device_mesh=x.device_mesh)(x)


def local_linear(fn, x, w, kept):
    """``fn(x, w)`` of an activation and a weight, where the output's first
    dims are ``x``'s dims listed in ``kept`` (x dim -> output dim; a dim
    not listed is contracted). A DTensor ``x`` is computed on each rank's
    own shard (``local_map``) against the whole ``w`` (gathered, as FSDP
    gathers a layer's weights): ``x`` keeps its shards on kept dims and
    the output takes them; a contracted dim is gathered first. DTensor's
    own strategies for these products flatten sharded dims, which it may
    refuse, or shard flattened head dims it cannot unflatten (8 kv heads
    on a 16-way 'model' axis). Grads: ``x``'s in its own layout, ``w``'s
    a partial sum over the mesh dims ``x`` is split on. A plain ``x``:
    ``fn(x, w)``."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not isinstance(x, DTensor):
        return fn(x, w)
    from torch.distributed.tensor.experimental import local_map
    x_pl, out_pl = [], []
    for p in x.placements:
        if p.is_shard() and p.dim in kept:
            x_pl.append(p)
            out_pl.append(Shard(kept[p.dim]))
        else:
            x_pl.append(Replicate())
            out_pl.append(Replicate())
    whole = (Replicate(),) * len(x_pl)
    w_grad = tuple(Partial() if p.is_shard() else Replicate() for p in x_pl)
    return local_map(fn, out_placements=(tuple(out_pl),),
                     in_placements=(tuple(x_pl), whole),
                     in_grad_placements=(tuple(x_pl), w_grad),
                     device_mesh=x.device_mesh,
                     redistribute_inputs=True)(x, w)


def local_einsum(eq: str, x, w):
    """``torch.einsum(eq, x, w)`` through ``local_linear``."""
    ins, out = eq.split("->")
    xs = ins.split(",")[0]
    kept = {i: out.index(c) for i, c in enumerate(xs) if c in out}
    return local_linear(lambda a, b: torch.einsum(eq, a, b), x, w, kept)


def local_matmul(x, w):
    """``x @ w`` of (..., d) by (d, f) through ``local_linear``."""
    return local_linear(lambda a, b: a @ b, x, w,
                        {i: i for i in range(x.ndim - 1)})


def local_rows(fn, x, *others):
    """``fn(x, *others)`` computed row by row over ``x``'s first two dims
    (a per-token loss of logits and labels): a DTensor ``x`` keeps its
    shards of dims 0 and 1 and is gathered elsewhere, each of ``others``
    (with the same first two dims) takes the same placements, each rank
    computes its own rows (``local_map``) and the output keeps them. A
    plain ``x``: ``fn(x, *others)``."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        return fn(x, *others)
    from torch.distributed.tensor.experimental import local_map
    x_pl = tuple(p if p.is_shard() and p.dim < 2 else Replicate()
                 for p in x.placements)
    o_pl = tuple(x_pl for _ in others)
    return local_map(fn, out_placements=(x_pl,),
                     in_placements=(x_pl,) + o_pl,
                     in_grad_placements=(x_pl,) + o_pl,
                     device_mesh=x.device_mesh,
                     redistribute_inputs=True)(x, *others)
