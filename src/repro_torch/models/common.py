"""Shared transformer building blocks (port of ``repro.models.common``):
norms, rotary, GQA attention (full, kv-chunked flash-style with per-chunk
recompute, and cached decode), gated MLP.

The arithmetic is the reference's, in its order and with its float32
casts: attention is plain tensor operations, not
``F.scaled_dot_product_attention``, so the port computes what the
reference computes.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from ..parallel.ctx import local_einsum, local_matmul
from .spec import ParamSpec


def rmsnorm_spec(d: int, dtype: str) -> dict:
    return {"scale": ParamSpec((d,), ("embed",), init="ones", dtype=dtype)}


def rmsnorm(x: torch.Tensor, p: dict, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * p["scale"].float()
    return out.to(x.dtype)


def rotary(x: torch.Tensor, positions: torch.Tensor,
           theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions broadcastable to (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(float(-np.log(theta))
                      * torch.arange(half, dtype=torch.float32,
                                     device=x.device) / half)
    ang = positions.float()[..., None] * freqs               # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                       # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


# ------------------------------ attention -------------------------------- #

def attn_specs(cfg, cross: bool = False) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    dt = cfg.param_dtype
    specs = {
        "wq": ParamSpec((d, h, hd), ("embed", "q_heads", "head_dim"),
                        dtype=dt),
        "wk": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head_dim"),
                        dtype=dt),
        "wv": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head_dim"),
                        dtype=dt),
        "wo": ParamSpec((h, hd, d), ("q_heads", "head_dim", "embed"),
                        dtype=dt),
    }
    if cfg.qkv_bias and not cross:
        specs["bq"] = ParamSpec((h, hd), ("q_heads", "head_dim"),
                                init="zeros", dtype=dt)
        specs["bk"] = ParamSpec((kv, hd), ("kv_heads", "head_dim"),
                                init="zeros", dtype=dt)
        specs["bv"] = ParamSpec((kv, hd), ("kv_heads", "head_dim"),
                                init="zeros", dtype=dt)
    return specs


def qkv_proj(p: dict, x: torch.Tensor, cfg
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    ct = x.dtype
    q = local_einsum("bsd,dhk->bshk", x, p["wq"].to(ct))
    k = local_einsum("bsd,dhk->bshk", x, p["wk"].to(ct))
    v = local_einsum("bsd,dhk->bshk", x, p["wv"].to(ct))
    if "bq" in p:
        q = q + p["bq"].to(ct)
        k = k + p["bk"].to(ct)
        v = v + p["bv"].to(ct)
    return q, k, v


def _block_attn(q, k, v, mask, scale):
    """Unnormalized block attention: returns (acc, lse_max, denom)."""
    s = torch.einsum("bsgkh,btkh->bkgst", q, k).float() * scale
    s = torch.where(mask, s, -1e30)
    m = torch.amax(s, dim=-1)                        # (B,KV,G,S)
    e = torch.exp(s - m[..., None])
    e = torch.where(mask, e, 0.0)
    denom = torch.sum(e, dim=-1)
    acc = torch.einsum("bkgst,btkh->bkgsh", e.to(v.dtype), v)
    return acc.float(), m, denom


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool, q_offset=0,
                  kv_len: Optional[torch.Tensor] = None,
                  chunk: int = 0) -> torch.Tensor:
    """Grouped-query attention.

    q: (B, S, H, hd); k, v: (B, T, KV, hd); H = KV * G.
    ``causal``: mask kv_idx > q_idx + q_offset.  ``kv_len``: valid cache
    length (decode).  ``chunk`` > 0 enables kv-chunked online-softmax
    (flash-style) when T > chunk — O(S * chunk) score memory, each chunk
    recomputed in the backward pass (the reference's ``jax.checkpoint``
    on its scan body).
    Returns (B, S, H, hd). DTensor inputs go through ``_gqa_sharded``.
    """
    if isinstance(q, DTensor):
        return _gqa_sharded(q, k, v, causal=causal, q_offset=q_offset,
                            kv_len=kv_len, chunk=chunk)
    b, sq, h, hd = q.shape
    t = k.shape[1]
    kv = k.shape[2]
    g = h // kv
    scale = float(np.float32(1.0 / np.sqrt(hd)))
    qg = q.reshape(b, sq, g, kv, hd)
    q_idx = torch.as_tensor(q_offset, device=q.device) + torch.arange(
        sq, device=q.device)

    def mask_for(t0, tc, valid):
        kv_idx = t0 + torch.arange(tc, device=q.device)
        m = torch.ones((sq, tc), dtype=torch.bool, device=q.device)
        if causal:
            m &= kv_idx[None, :] <= q_idx[:, None]
        if valid is not None:
            m &= kv_idx[None, :] < torch.as_tensor(valid, device=q.device)
        return m[None, None, None]                   # (1,1,1,S,Tc)

    def finish(acc, denom):
        out = acc / torch.clamp(denom, min=1e-30)[..., None]
        # acc dims (B, KV, G, S, hd) -> (B, S, G, KV, hd) -> (B, S, H, hd),
        # inverting the q reshape (b, sq, g, kv, hd).
        return out.to(q.dtype).permute(0, 3, 2, 1, 4).reshape(b, sq, h, hd)

    if chunk <= 0 or t <= chunk:
        acc, _, denom = _block_attn(qg, k, v, mask_for(0, t, kv_len), scale)
        return finish(acc, denom)

    n_chunks = -(-t // chunk)
    pad = n_chunks * chunk - t
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        eff_len = kv_len if kv_len is not None else t
    else:
        eff_len = kv_len

    def body(m_run, d_run, a_run, t0, kb, vb):
        acc, m_blk, d_blk = _block_attn(qg, kb, vb,
                                        mask_for(t0, chunk, eff_len), scale)
        m_new = torch.maximum(m_run, m_blk)
        s_run = torch.exp(m_run - m_new)
        s_blk = torch.exp(m_blk - m_new)
        d_new = d_run * s_run + d_blk * s_blk
        a_new = a_run * s_run[..., None] + acc * s_blk[..., None]
        return m_new, d_new, a_new

    recompute = torch.is_grad_enabled()
    m_run = torch.full((b, kv, g, sq), -torch.inf, dtype=torch.float32,
                       device=q.device)
    d_run = torch.zeros((b, kv, g, sq), dtype=torch.float32, device=q.device)
    a_run = torch.zeros((b, kv, g, sq, hd), dtype=torch.float32,
                        device=q.device)
    for i in range(n_chunks):
        kb = k[:, i * chunk:(i + 1) * chunk]
        vb = v[:, i * chunk:(i + 1) * chunk]
        if recompute:
            m_run, d_run, a_run = checkpoint(
                body, m_run, d_run, a_run, i * chunk, kb, vb,
                use_reentrant=False)
        else:
            m_run, d_run, a_run = body(m_run, d_run, a_run, i * chunk, kb,
                                       vb)
    return finish(a_run, d_run)


def _gqa_sharded(q, k, v, *, causal, q_offset, kv_len, chunk):
    """``gqa_attention`` of DTensors on each rank's rows (``local_map``):
    the batch keeps its shards, the queries keep a shard of the sequence
    (their causal offset shifted by the shard's start) while k and v are
    gathered whole along it, every other dim is gathered. DTensor's own
    strategies for the score products flatten sharded dims, which some
    versions refuse. Grads: q's in its layout; k's and v's partial sums
    over the mesh dims that split the queries' sequence."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from torch.distributed.tensor.experimental import local_map

    from ..parallel.ctx import local_value
    q_pl, kv_pl, kv_grad = [], [], []
    for p in q.placements:
        if p.is_shard(0):
            q_pl.append(p), kv_pl.append(p), kv_grad.append(p)
        elif p.is_shard(1):
            q_pl.append(p), kv_pl.append(Replicate())
            kv_grad.append(Partial())
        else:
            q_pl.append(Replicate()), kv_pl.append(Replicate())
            kv_grad.append(Replicate())
    mesh = q.device_mesh
    start = compute_local_shape_and_global_offset(q.shape, mesh, q_pl)[1][1]
    q_offset, kv_len = local_value(q_offset), local_value(kv_len)

    def core(ql, kl, vl):
        return gqa_attention(ql, kl, vl, causal=causal,
                             q_offset=q_offset + start, kv_len=kv_len,
                             chunk=chunk)
    return local_map(core, out_placements=(tuple(q_pl),),
                     in_placements=(tuple(q_pl), tuple(kv_pl),
                                    tuple(kv_pl)),
                     in_grad_placements=(tuple(q_pl), tuple(kv_grad),
                                         tuple(kv_grad)),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)


def attn_out(p: dict, y: torch.Tensor) -> torch.Tensor:
    return local_einsum("bshk,hkd->bsd", y, p["wo"].to(y.dtype))


# --------------------------------- mlp ----------------------------------- #

def mlp_specs(cfg, d_ff: Optional[int] = None, gated: bool = True) -> dict:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    dt = cfg.param_dtype
    specs = {
        "wi": ParamSpec((d, f), ("embed", "ffn"), dtype=dt),
        "wo": ParamSpec((f, d), ("ffn", "embed"), dtype=dt),
    }
    if gated:
        specs["wg"] = ParamSpec((d, f), ("embed", "ffn"), dtype=dt)
    return specs


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x * sigmoid(x), two operations in x's dtype."""
    return x * torch.sigmoid(x)


def mlp(p: dict, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    ct = x.dtype
    h = local_matmul(x, p["wi"].to(ct))
    if "wg" in p:
        h = silu(h) * local_matmul(x, p["wg"].to(ct))
    else:
        h = F.gelu(h, approximate="tanh") if act == "gelu" else silu(h)
    return local_matmul(h, p["wo"].to(ct))
