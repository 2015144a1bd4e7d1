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


def _owns(x) -> bool:
    """Whether this rank's copy of DTensor ``x``'s local block counts in a
    sum over the mesh: on a mesh dim that replicates ``x``, only the rank
    at coordinate 0 holds the counted copy."""
    coord = x.device_mesh.get_coordinate()
    return all(c == 0 for c, p in zip(coord, x.placements)
               if p.is_replicate())


def _flat_group(mesh):
    """One process group over every rank of ``mesh``."""
    import torch.distributed as dist
    if mesh.ndim == 1:
        return mesh.get_group()
    if mesh.size() == dist.get_world_size():
        return dist.group.WORLD
    return mesh._flatten().get_group()


class _MeshSum(torch.autograd.Function):
    """Forward: the sum over ``group``'s ranks of each rank's ``part``
    (``part`` where ``keep``, else zero), one all-reduce. Backward: the
    replicated grad, unchanged, to every rank's ``part``."""

    @staticmethod
    def forward(ctx, part, keep: bool, group):
        from torch.distributed import _functional_collectives as funcol
        x = part if keep else torch.zeros_like(part)
        return funcol.wait_tensor(funcol.all_reduce(x, "sum", group))

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def mesh_sum(part: torch.Tensor, mesh, keep: bool = True):
    """A replicated DTensor on ``mesh`` holding the sum over its ranks of
    each rank's plain tensor ``part`` (left out where ``keep`` is false),
    by one all-reduce over the whole mesh, so every rank gets the same
    bits. DTensor would reduce a sum partial over several mesh dims one
    dim at a time. On a mesh of one rank, ``part`` itself."""
    from torch.distributed.tensor import DTensor, Replicate
    if mesh.size() > 1:
        part = _MeshSum.apply(part, keep, _flat_group(mesh))
    return DTensor.from_local(part, mesh, (Replicate(),) * mesh.ndim,
                              run_check=False)


def sum_squares(leaves) -> torch.Tensor:
    """The sum of squares of every element of ``leaves``, in float32: on
    plain tensors one running sum, leaf by leaf; on DTensors each rank's
    running sum over its own blocks (a replicated block counted once),
    then one all-reduce (``mesh_sum``)."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = next((t.device_mesh for t in leaves if isinstance(t, DTensor)),
                None)
    total = 0
    for leaf in leaves:
        if mesh is not None:
            if not isinstance(leaf, DTensor):      # a plain leaf: replicated
                leaf = DTensor.from_local(leaf, mesh, (Replicate(),)
                                          * mesh.ndim, run_check=False)
            if not _owns(leaf):
                continue
            leaf = leaf.to_local()
        total = total + torch.sum(torch.square(leaf.float()))
    if mesh is None:
        return total
    if not torch.is_tensor(total):
        total = torch.zeros((), dtype=torch.float32,
                            device=mesh.device_type)
    return mesh_sum(total, mesh)


def mesh_mean(x):
    """``torch.mean(x)``; a DTensor's as each rank's mean of its own
    block, weighted by its share of the elements, summed over the mesh by
    one all-reduce (``mesh_sum``): a replicated DTensor."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return torch.mean(x)
    local = x.to_local()
    part = torch.mean(local)
    if local.numel() != x.numel():
        part = part * (local.numel() / x.numel())
    return mesh_sum(part, x.device_mesh, keep=_owns(x))


def local_heads(fn, args, heads, out_heads):
    """``fn(*args)`` for a function that treats each sequence (dim 0) and
    each head on its own: ``heads[i]`` is ``args[i]``'s head dim (None: a
    tensor every head shares), ``out_heads`` the outputs' head dims. A
    DTensor first argument sets the layout: each rank computes its own
    sequences and heads (``local_map``), the arguments split as the first
    one is on dim 0 and on its head dim and gathered elsewhere; the grad
    of a shared tensor is a partial sum over the mesh dims that split the
    heads. Plain tensors: ``fn(*args)``."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    ref = args[0]
    if not isinstance(ref, DTensor):
        return fn(*args)
    from torch.distributed.tensor.experimental import local_map

    def layout(head, shared):
        out = []
        for p in ref.placements:
            if p.is_shard(0):
                out.append(Shard(0))
            elif p.is_shard(heads[0]):
                out.append(Shard(head) if head is not None else shared)
            else:
                out.append(Replicate())
        return tuple(out)
    return local_map(
        fn, out_placements=tuple(layout(h, Replicate()) for h in out_heads),
        in_placements=tuple(layout(h, Replicate()) for h in heads),
        in_grad_placements=tuple(layout(h, Partial()) for h in heads),
        device_mesh=ref.device_mesh, redistribute_inputs=True)(*args)


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


def tp_matmul(x, w):
    """``x @ w`` of (..., k) by a weight (k, f), planned per mesh dim: a
    dim that splits ``x``'s rows keeps them and gathers ``w`` (FSDP, its
    grad a partial sum); else one that splits ``w``'s columns keeps them
    (tensor parallel: the output's last dim split, ``x``'s grad partial);
    else one that splits the contraction splits ``x``'s last dim too (the
    output partial); else both whole. DTensor's own plan, where the rows
    span two mesh dims ('pod', 'data') and the weight's rows two as well,
    computed more rows than the rank's own. A plain ``x``: ``x @ w``."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not isinstance(x, DTensor):
        return x @ w
    from torch.distributed.tensor.experimental import local_map
    last = x.ndim - 1
    rep = Replicate()
    x_pl, w_pl, o_pl, x_gr, w_gr = [], [], [], [], []
    for px, pw in zip(x.placements, w.placements):
        if px.is_shard() and px.dim < last:
            plan = (px, rep, px, px, Partial())
        elif pw.is_shard(1):
            plan = (rep, pw, Shard(last), Partial(), pw)
        elif pw.is_shard(0):
            plan = (Shard(last), pw, Partial(), Shard(last), pw)
        else:
            plan = (rep,) * 5
        for acc, p in zip((x_pl, w_pl, o_pl, x_gr, w_gr), plan):
            acc.append(p)
    return local_map(lambda a, b: a @ b, out_placements=(tuple(o_pl),),
                     in_placements=(tuple(x_pl), tuple(w_pl)),
                     in_grad_placements=(tuple(x_gr), tuple(w_gr)),
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
