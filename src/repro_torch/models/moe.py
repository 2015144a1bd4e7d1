"""Mixture-of-Experts layer (port of ``repro.models.moe``): GShard-style
top-k routing with grouped capacity dispatch through one-hot products.
Used by kimi-k2 (384 experts, top-8) and grok-1 (8 experts, top-2).

Tokens are split into ``moe_groups`` groups per sequence, each with a
capacity C = ceil(group_tokens * topk * cf / E) per expert; a choice past
its expert's capacity is dropped (its gate is zero). The router runs in
float32, and the Switch load-balance loss is returned to the trainer.

The reference's ``constrain`` calls (sharding constraints on the dispatch
tensor, the experts' inputs, hidden and outputs, and the combine weights)
stand after each of those products; without an activation-sharding
context they return their argument. Each three-operand product of the
reference is contracted pairwise in an order that keeps every
intermediate at the size of the (B, G, T, E, C) dispatch tensor or
below, and the expert FFN is one batched product over the experts.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from ..parallel.ctx import bincount, constrain
from .common import silu
from .spec import ParamSpec


def moe_specs(cfg) -> dict:
    d, e, f = cfg.d_model, cfg.moe_experts, cfg.moe_dff
    dt = cfg.param_dtype
    return {
        "router": ParamSpec((d, e), ("embed", "experts_r"), dtype="float32"),
        "wi": ParamSpec((e, d, f), ("experts", "embed", "expert_ffn"),
                        dtype=dt),
        "wg": ParamSpec((e, d, f), ("experts", "embed", "expert_ffn"),
                        dtype=dt),
        "wo": ParamSpec((e, f, d), ("experts", "expert_ffn", "embed"),
                        dtype=dt),
    }


def n_groups(cfg, s: int) -> int:
    """The reference's group count for a sequence of ``s``: ``moe_groups``
    (at most ``s``), lowered until it divides ``s``."""
    g = min(cfg.moe_groups, s) or 1
    while s % g:
        g -= 1
    return g


class Routing(NamedTuple):
    """One layer's routing of (B, G, T) tokens over E experts, top-k."""
    topi: torch.Tensor     # (B, G, T, k) int64, experts by falling prob
    topv: torch.Tensor     # (B, G, T, k) float32, renormalised over k
    pos: torch.Tensor      # (B, G, T, k) float32, slot in the expert
    keep: torch.Tensor     # (B, G, T, k) bool, pos < cap
    cap: int               # C, the slots of each expert per group
    aux: torch.Tensor      # () float32, the Switch load-balance loss


def capacity_onehot(pos: torch.Tensor, keep: torch.Tensor,
                    cap: int) -> torch.Tensor:
    """``jax.nn.one_hot(where(keep, pos, cap), cap)`` in float32: a dropped
    choice (index ``cap``) gets a row of zeros, where ``F.one_hot`` would
    raise."""
    idx = torch.where(keep, pos, float(cap))
    slots = torch.arange(cap, dtype=idx.dtype, device=idx.device)
    return (idx[..., None] == slots).float()


def route(p: dict, tokens: torch.Tensor, cfg) -> Routing:
    """Top-k softmax routing of ``tokens`` (B, G, T, d) in float32, each
    choice's slot in its expert's buffer (a cumulative count over the
    group's (T, k) choices in order), and the aux loss."""
    b, g, t, _ = tokens.shape
    e, k = cfg.moe_experts, cfg.moe_topk
    cap = max(int(np.ceil(t * k * cfg.moe_cf / e)), 1)
    logits = tokens.float() @ p["router"].float()               # (B,G,T,E)
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.topk(probs, k, dim=-1, sorted=True)      # (B,G,T,k)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)

    # load-balance aux loss (Switch): E * sum_e f_e * p_e
    me = probs.mean(dim=(0, 1, 2))                              # (E,)
    ce = bincount(topi.reshape(-1), minlength=e).float() / (
        b * g * t * k)
    aux = e * torch.sum(me * ce)

    # position of each (token, choice) within its expert's capacity buffer
    onehot = torch.nn.functional.one_hot(topi, e).float()      # (B,G,T,k,E)
    flat = onehot.reshape(b, g, t * k, e)
    pos = (torch.cumsum(flat, dim=2) - flat).reshape(b, g, t, k, e)
    pos = torch.sum(pos * onehot, dim=-1)                       # (B,G,T,k)
    return Routing(topi, topv, pos, pos < cap, cap, aux)


def route_layer(p: dict, x: torch.Tensor, cfg) -> Routing:
    """The routing ``moe_layer`` takes for ``x`` (B, S, d): ``route`` over
    the sequence cut into its ``n_groups`` groups."""
    b, s, d = x.shape
    g = n_groups(cfg, s)
    return route(p, x.reshape(b, g, s // g, d), cfg)


def expert_ffn(expert_in: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor,
               wo: torch.Tensor, ct) -> torch.Tensor:
    """The gated expert FFN of (B, G, E, C, d) inputs: one batched product
    over the experts per weight."""
    h = torch.einsum("bgecd,edf->bgecf", expert_in, wi.to(ct))
    hg = torch.einsum("bgecd,edf->bgecf", expert_in, wg.to(ct))
    h = constrain(silu(h) * hg, "act_batch", None, "experts", None,
                  "expert_ffn")
    return torch.einsum("bgecf,efd->bgecd", h, wo.to(ct))


def _expert_ffn_sharded(expert_in, p: dict, ct):
    """``expert_ffn`` of sharded weights on each rank's shards
    (``local_map``): DTensor's backward of the product over a sharded
    expert FFN dim (grok-1's layout) takes a view its local strides do
    not allow. Per mesh dim, a weight keeps a shard of its expert dim
    (EP) or of its FFN dim (TP) and is gathered otherwise (its FSDP shard
    of d); the inputs follow the experts' shard, are whole over an FFN
    shard, and keep their batch shard; the output is split over the
    experts, a partial sum over the FFN shard, else as the inputs."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    w_in, w_out, x_pl, out_pl = [], [], [], []
    gw_in, gw_out, gx = [], [], []              # the grads' placements
    for pi, px in zip(p["wi"].placements, expert_in.placements):
        if pi.is_shard(0):                        # experts: EP
            w_in.append(Shard(0)), w_out.append(Shard(0))
            x_pl.append(Shard(2)), out_pl.append(Shard(2))
            gw_in.append(Shard(0)), gw_out.append(Shard(0))
            gx.append(Shard(2))
        elif pi.is_shard(2):                      # expert_ffn: TP
            w_in.append(Shard(2)), w_out.append(Shard(1))
            x_pl.append(Replicate()), out_pl.append(Partial())
            gw_in.append(Shard(2)), gw_out.append(Shard(1))
            gx.append(Partial())                  # each F shard's part
        else:
            keep = px if px.is_shard(0) else Replicate()
            w_in.append(Replicate()), w_out.append(Replicate())
            x_pl.append(keep), out_pl.append(keep), gx.append(keep)
            # a batch shard's grad of a whole weight is a partial sum
            gw = Partial() if keep.is_shard() else Replicate()
            gw_in.append(gw), gw_out.append(gw)
    fn = local_map(
        lambda x, wi, wg, wo: expert_ffn(x, wi, wg, wo, ct),
        out_placements=(tuple(out_pl),),
        in_placements=(tuple(x_pl), tuple(w_in), tuple(w_in), tuple(w_out)),
        in_grad_placements=(tuple(gx), tuple(gw_in), tuple(gw_in),
                            tuple(gw_out)),
        device_mesh=p["wi"].device_mesh, redistribute_inputs=True)
    return fn(expert_in, p["wi"], p["wg"], p["wo"])


def moe_layer(p: dict, x: torch.Tensor, cfg
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux_loss). Top-k softmax routing, capacity drop."""
    b, s, d = x.shape
    e = cfg.moe_experts
    ct = x.dtype
    r = route_layer(p, x, cfg)
    g = r.topi.shape[1]
    tokens = x.reshape(b, g, s // g, d)                         # (B,G,T,d)
    gate = r.topv * r.keep.to(r.topv.dtype)
    kept = (torch.nn.functional.one_hot(r.topi, e).float()
            * r.keep[..., None].float())                        # (B,G,T,k,E)
    pos_oh = capacity_onehot(r.pos, r.keep, r.cap)              # (B,G,T,k,C)
    # dispatch (B,G,T,E,C): a product over k for each token
    disp = torch.einsum("bgtke,bgtkc->bgtec", kept, pos_oh)
    disp = constrain(disp, "act_batch", None, None, "experts", None)
    expert_in = torch.einsum("bgtec,bgtd->bgecd", disp.to(ct), tokens)
    expert_in = constrain(expert_in, "act_batch", None, "experts", None,
                          None)

    # the expert FFN, one batched product over the experts
    if isinstance(p["wi"], DTensor):
        expert_out = _expert_ffn_sharded(expert_in, p, ct)
    else:
        expert_out = expert_ffn(expert_in, p["wi"], p["wg"], p["wo"], ct)
    expert_out = constrain(expert_out, "act_batch", None, "experts", None,
                           None)

    # combine weights: the gate folded into the dispatch's first operand
    cw = torch.einsum("bgtke,bgtkc->bgtec", kept * gate[..., None], pos_oh)
    cw = constrain(cw, "act_batch", None, None, "experts", None)
    y = torch.einsum("bgtec,bgecd->bgtd", cw.to(ct), expert_out)
    return y.reshape(b, s, d), r.aux
