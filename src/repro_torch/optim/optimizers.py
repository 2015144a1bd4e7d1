"""Optimizers built on the ParamSpec tree system (port of
``repro.optim.optimizers``; no external deps).

AdamW for everything up to a few hundred B params; Adafactor (factored
second moments, no first moment) for the 1T-class MoE where AdamW's fp32
moments exceed the per-chip memory budget. Optimizer-state *specs* mirror
parameter specs. ``apply`` is functional, as the reference's: it returns
new params and state and leaves its arguments as they were.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Tuple

import torch

from ..models import spec as spec_mod
from ..models.spec import ParamSpec, tree_leaves, tree_map
from ..parallel.ctx import like, sum_squares


class Optimizer(NamedTuple):
    name: str
    state_specs: Callable[[Any], Any]          # param_specs -> state specs
    apply: Callable[..., Tuple[Any, Any]]      # (params,grads,state,lr,step)


def global_norm(tree) -> torch.Tensor:
    """The l2 norm of every leaf together; over DTensor leaves one
    all-reduce for the whole mesh (``ctx.sum_squares``), so every rank
    holds the same bits."""
    return torch.sqrt(sum_squares(tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    # scale in the grad's own dtype: an f32 round-trip materializes an fp32
    # copy of every grad leaf
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def _map_leaves(fn, params, grads, state):
    """Recurse param/grad/state dicts in lockstep; state subtree per leaf.
    Returns (new_params, new_state)."""
    if isinstance(params, dict):
        out = {k: _map_leaves(fn, params[k], grads[k], state[k])
               for k in params}
        return ({k: v[0] for k, v in out.items()},
                {k: v[1] for k, v in out.items()})
    return _sliced(fn, params, like(grads, params), state)


# float32 temporaries of the sliced update, in elements: slices of the
# leading axis are updated together up to this size
_SLICE_ELEMS = 1 << 24


def _sliced(fn, p, g, st):
    """Apply an update per slice of the leading axis of a leaf of three or
    more dims, as the reference's ``lax.map`` does: float32 temporaries
    of a few slices, never of a whole stacked leaf. As many slices as fit
    ``_SLICE_ELEMS`` (at least one) are updated by one call of ``fn``
    with ``lead=1``, which takes its per-slice reductions (Adafactor's
    update RMS) over every dim but the leading one; so a leaf of many
    small slices (zamba2's shared attention (d, heads, head_dim): 3584 of
    them) costs a few launches per op, not one per slice. Plain tensors
    and DTensors take the same path: the leading (layer) dim is never
    sharded, and a DTensor's reductions over its sharded dims are DTensor
    ops (``torch.vmap`` would take them per shard)."""
    n = p.shape[0] if p.ndim >= 3 else 1
    k = max(1, _SLICE_ELEMS // max(1, p[0].numel())) if n > 1 else n
    if k >= n:
        # one call; a DTensor's results back in their inputs' layouts
        new_p, new_st = fn(p, g, st, lead=int(n > 1))
        return like(new_p, p), tree_map(like, new_st, st)
    new_p = torch.empty_like(p)
    new_st = tree_map(torch.empty_like, st)
    for i in range(0, n, k):
        pi, sti = fn(p[i:i + k], g[i:i + k],
                     tree_map(lambda a: a[i:i + k], st), lead=1)
        new_p[i:i + k] = like(pi, p)
        tree_map(lambda dst, src: dst[i:i + k].copy_(like(src, dst)),
                 new_st, sti)
    return new_p, new_st


# --------------------------------- AdamW ---------------------------------- #

def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, moment_dtype: str = "float32"
          ) -> Optimizer:
    def state_specs(param_specs):
        def f(path, s: ParamSpec):
            z = dataclasses.replace(s, init="zeros", dtype=moment_dtype)
            return {"m": z, "v": z}
        return spec_mod.map_specs(f, param_specs)

    def apply(params, grads, state, lr, step):
        t = (step + 1).float()
        c1 = 1.0 - torch.pow(b1, t)
        c2 = 1.0 - torch.pow(b2, t)
        md = spec_mod.torch_dtype(moment_dtype)

        def upd(p, g, st, lead=0):
            # element-wise: lead (the slices updated together) changes
            # nothing
            gf = g.float()
            m = b1 * st["m"].float() + (1 - b1) * gf
            v = b2 * st["v"].float() + (1 - b2) * gf * gf
            u = (m / c1) / (torch.sqrt(v / c2) + eps)
            pf = p.float()
            pf = pf - lr * (u + weight_decay * pf)
            return pf.to(p.dtype), {"m": m.to(md), "v": v.to(md)}

        return _map_leaves(upd, params, grads, state)

    return Optimizer("adamw", state_specs, apply)


# ------------------------------- Adafactor -------------------------------- #

def adafactor(eps: float = 1e-30, clip_threshold: float = 1.0,
              decay: float = 0.8, weight_decay: float = 0.0) -> Optimizer:
    """Factored second moments for >=2-D params; scalars/vectors keep a full
    second moment. No first moment."""

    def state_specs(param_specs):
        def f(path, s: ParamSpec):
            if len(s.shape) >= 2:
                return {
                    "vr": ParamSpec(s.shape[:-1], s.axes[:-1], init="zeros",
                                    dtype="float32"),
                    "vc": ParamSpec(s.shape[:-2] + s.shape[-1:],
                                    s.axes[:-2] + s.axes[-1:], init="zeros",
                                    dtype="float32"),
                }
            return {"v": ParamSpec(s.shape, s.axes, init="zeros",
                                   dtype="float32")}
        return spec_mod.map_specs(f, param_specs)

    def apply(params, grads, state, lr, step):
        t = (step + 1).float()
        beta = 1.0 - torch.pow(t, -decay)

        def upd(p, g, st, lead=0):
            # lead: leading (layer) dims the per-slice RMS keeps apart
            gf = g.float()
            g2 = gf * gf + eps
            if "v" in st:
                v = beta * st["v"] + (1 - beta) * g2
                u = gf * torch.rsqrt(v + eps)
                new_st = {"v": v}
            else:
                vr = beta * st["vr"] + (1 - beta) * torch.mean(g2, dim=-1)
                vc = beta * st["vc"] + (1 - beta) * torch.mean(g2, dim=-2)
                denom = torch.clamp(torch.mean(vr, dim=-1, keepdim=True),
                                    min=eps)
                vhat = (vr / denom)[..., None] * vc[..., None, :]
                u = gf * torch.rsqrt(vhat + eps)
                new_st = {"vr": vr, "vc": vc}
            if lead:
                ms_u = torch.mean(u * u, dim=tuple(range(lead, u.ndim)),
                                  keepdim=True)
            else:
                ms_u = torch.mean(u * u)
            rms_u = torch.sqrt(ms_u + eps)
            u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
            pf = p.float()
            pf = pf - lr * (u + weight_decay * pf)
            return pf.to(p.dtype), new_st

        return _map_leaves(upd, params, grads, state)

    return Optimizer("adafactor", state_specs, apply)


def get_optimizer(name: str) -> Optimizer:
    if name == "adamw":
        return adamw()
    if name == "adafactor":
        return adafactor()
    raise ValueError(f"unknown optimizer {name}")


# ------------------------------- schedules -------------------------------- #

def cosine_schedule(peak_lr: float = 3e-4, warmup: int = 100,
                    total: int = 10_000, floor: float = 0.1):
    def lr(step):
        s = step.float()
        warm = s / max(1.0, warmup)
        prog = torch.clamp((s - warmup) / max(1.0, total - warmup), 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return peak_lr * torch.where(s < warmup, warm, cos)
    return lr
