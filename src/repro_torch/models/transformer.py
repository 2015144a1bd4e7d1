"""Decoder-only LM of the dense, moe, ssm, hybrid and vlm families (port
of ``repro.models.transformer``), with the stacked-layer loop + remat,
KV/SSM caches, prefill and decode steps.

One code path serves minitron-4b, granite-3-8b, qwen1.5-32b, yi-9b,
pixtral-12b (text backbone + stub image-embedding prefix), kimi-k2,
grok-1, falcon-mamba-7b and zamba2-7b; whisper-small's encoder-decoder is
``encdec.py``. The reference's ``constrain`` calls stand at the entry
and exit of each layer (``_run_layers``): under
``parallel.ctx.activation_sharding`` they lay the residual stream out as
('act_batch', 'act_seq', None); without it they return their argument.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..parallel.ctx import (constrain, local_linear, local_matmul,
                            local_rows, mesh_mean)
from . import common, moe as moe_mod, ssm as ssm_mod
from .spec import ParamSpec, stack_layers, torch_dtype

AUX_LOSS_WEIGHT = 0.01


# ------------------------------ param specs ------------------------------ #

def _layer_specs(cfg) -> dict:
    if cfg.family == "ssm":
        return {"norm": common.rmsnorm_spec(cfg.d_model, cfg.param_dtype),
                "mamba": (ssm_mod.mamba1_specs(cfg) if cfg.mamba_version == 1
                          else ssm_mod.mamba2_specs(cfg))}
    if cfg.family == "hybrid":
        return {"norm": common.rmsnorm_spec(cfg.d_model, cfg.param_dtype),
                "mamba": ssm_mod.mamba2_specs(cfg)}
    block = {
        "ln1": common.rmsnorm_spec(cfg.d_model, cfg.param_dtype),
        "attn": common.attn_specs(cfg),
        "ln2": common.rmsnorm_spec(cfg.d_model, cfg.param_dtype),
    }
    if cfg.family == "moe":
        block["moe"] = moe_mod.moe_specs(cfg)
    else:
        block["mlp"] = common.mlp_specs(cfg)
    return block


def build_specs(cfg) -> dict:
    specs: Dict[str, Any] = {
        "embed": {"tokens": ParamSpec((cfg.vocab_padded, cfg.d_model),
                                      ("vocab", "embed"),
                                      dtype=cfg.param_dtype)},
        "layers": stack_layers(_layer_specs(cfg), cfg.n_layers),
        "final_norm": common.rmsnorm_spec(cfg.d_model, cfg.param_dtype),
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = ParamSpec((cfg.d_model, cfg.vocab_padded),
                                     ("embed", "vocab"),
                                     dtype=cfg.param_dtype)
    if cfg.family == "hybrid":
        # zamba2: ONE shared attention block reused every `attn_every` layers
        specs["shared_attn"] = {
            "ln1": common.rmsnorm_spec(cfg.d_model, cfg.param_dtype),
            "attn": common.attn_specs(cfg),
            "ln2": common.rmsnorm_spec(cfg.d_model, cfg.param_dtype),
            "mlp": common.mlp_specs(cfg),
        }
    return specs


# ------------------------------- caches ---------------------------------- #

def _kv_specs(n: int, batch: int, max_len: int, cfg) -> dict:
    shape = (n, batch, max_len, cfg.n_kv, cfg.head_dim)
    axes = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
    return {"k": ParamSpec(shape, axes, dtype=cfg.compute_dtype),
            "v": ParamSpec(shape, axes, dtype=cfg.compute_dtype)}


def _ssm_state_specs(cfg, batch: int) -> dict:
    """Per layer: the conv's last inputs and the float32 SSM state."""
    di, n, cv = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    mamba2 = cfg.family == "hybrid" or cfg.mamba_version == 2
    conv = ParamSpec((cfg.n_layers, batch, cv - 1,
                      di + (2 * n if mamba2 else 0)),
                     ("layers", "batch", None, "inner"),
                     dtype=cfg.compute_dtype)
    if mamba2:
        ssm = ParamSpec((cfg.n_layers, batch, cfg.ssm_heads, n,
                         di // cfg.ssm_heads),
                        ("layers", "batch", "heads", "state", None),
                        dtype="float32")
    else:
        ssm = ParamSpec((cfg.n_layers, batch, di, n),
                        ("layers", "batch", "inner", "state"),
                        dtype="float32")
    return {"conv": conv, "ssm": ssm}


def cache_specs(cfg, batch: int, max_len: int) -> dict:
    """Cache layout for serving: a KV cache per layer; per-layer conv and
    SSM states (ssm); both, with a KV cache per application of the shared
    attention block (hybrid)."""
    specs: Dict[str, Any] = {}
    if cfg.family in ("ssm", "hybrid"):
        specs.update(_ssm_state_specs(cfg, batch))
    if cfg.family == "hybrid":
        specs.update(_kv_specs(cfg.n_layers // cfg.attn_every, batch,
                               max_len, cfg))
    elif cfg.family != "ssm":
        specs.update(_kv_specs(cfg.n_layers, batch, max_len, cfg))
    specs["len"] = ParamSpec((), (), init="zeros", dtype="int32")
    return specs


# ------------------------------- forward --------------------------------- #

def _update_cache(cache: torch.Tensor, new: torch.Tensor,
                  start: torch.Tensor) -> torch.Tensor:
    """``lax.dynamic_update_slice(cache, new, (0, start, 0, 0))``: a new
    cache with ``new`` written at ``start`` along axis 1, the start clamped
    so that the slice fits (no host read of ``start``)."""
    s, t = new.shape[1], cache.shape[1]
    start = torch.clamp(start.to(torch.int64), 0, t - s)
    idx = start + torch.arange(s, device=cache.device)
    return cache.index_copy(1, idx, new.to(cache.dtype))


def _attn_block(cfg, p, x, positions, k_cache=None, v_cache=None,
                cache_len=None):
    """Pre-norm attention block. Returns (residual_out, k, v) where k/v are
    the UPDATED caches in decode mode and this block's fresh k/v otherwise."""
    h = common.rmsnorm(x, p["ln1"])
    q, k, v = common.qkv_proj(p["attn"], h, cfg)
    q = common.rotary(q, positions, cfg.rope_theta)
    k = common.rotary(k, positions, cfg.rope_theta)
    if k_cache is not None:
        # decode: write this step's k/v at `cache_len`, attend over cache
        k = _update_cache(k_cache, k, cache_len)
        v = _update_cache(v_cache, v, cache_len)
        y = common.gqa_attention(
            q, k, v, causal=False, q_offset=cache_len,
            kv_len=cache_len + q.shape[1],
            chunk=cfg.attn_chunk if k.shape[1] > cfg.attn_chunk else 0)
    else:
        y = common.gqa_attention(
            q, k, v, causal=True,
            chunk=cfg.attn_chunk if q.shape[1] > cfg.attn_chunk else 0)
    out = x + common.attn_out(p["attn"], y)
    return out, k, v


def _mixer_block(cfg, p, x, positions, cache_slice, mode: str):
    """One layer. mode: 'train' | 'prefill' | 'decode'.
    Returns (x, new_cache_slice, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family in ("ssm", "hybrid"):
        h = common.rmsnorm(x, p["norm"])
        fwd = (ssm_mod.mamba1_forward
               if cfg.family == "ssm" and cfg.mamba_version == 1
               else ssm_mod.mamba2_forward)
        state = None if mode == "train" else cache_slice
        y, new_state = fwd(p["mamba"], h, cfg, state)
        return x + y, new_state, aux

    if mode == "decode":
        x, k, v = _attn_block(cfg, p, x, positions,
                              k_cache=cache_slice["k"],
                              v_cache=cache_slice["v"],
                              cache_len=cache_slice["len"])
    else:
        x, k, v = _attn_block(cfg, p, x, positions)
    new_cache = {"k": k, "v": v} if mode != "train" else None

    h = common.rmsnorm(x, p["ln2"])
    if cfg.family == "moe":
        y, aux = moe_mod.moe_layer(p["moe"], h, cfg)
    else:
        y = common.mlp(p["mlp"], h)
    return x + y, new_cache, aux


def _unstack(tree):
    """The per-layer slices of a stacked tree: one ``unbind`` per leaf, so
    that the backward pass stacks the layers' grads once instead of adding
    a zero-padded copy of the whole leaf per layer."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: parts[k][i] for k in parts} for i in range(n)]
    return tree.unbind(0)


def layer_call(cfg, fn, *args):
    """``fn(*args)`` for one layer of a stack, under
    ``torch.utils.checkpoint`` when ``cfg.remat`` and grads are on (the
    reference's ``jax.checkpoint`` of its scan body)."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _run_layers(cfg, params, x, positions, cache, mode: str):
    """The loop over the layer stack (the reference's ``lax.scan``); each
    layer through ``layer_call``.

    hybrid (zamba2): after each group of ``attn_every`` Mamba-2 layers, the
    SHARED block's attention half (``_attn_block``: its ``ln1`` and
    ``attn``; the reference declares its ``ln2`` and ``mlp`` but does not
    apply them), its weights reused, outside the remat, with a KV cache
    per application; the ``n_layers % attn_every`` layers left over have
    none after them. Returns (x, new_cache, aux_sum)."""
    keys = ("conv", "ssm") if cfg.family in ("ssm", "hybrid") else ("k", "v")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new = {key: [] for key in keys + ("shared_k", "shared_v")}
    for i, lp in enumerate(_unstack(params["layers"])):
        cs = None
        if mode == "decode":
            cs = {key: cache[key][i] for key in keys}
            if "k" in cs:
                cs["len"] = cache["len"]
        x = constrain(x, "act_batch", "act_seq", None)
        x, ncs, a = layer_call(cfg, _mixer_block, cfg, lp, x, positions,
                               cs, mode)
        x = constrain(x, "act_batch", "act_seq", None)
        aux = aux + a
        if mode != "train":
            for key in keys:
                new[key].append(ncs[key])
        if cfg.family == "hybrid" and (i + 1) % cfg.attn_every == 0:
            app = i // cfg.attn_every
            kv = {}
            if mode == "decode":
                kv = {"k_cache": cache["k"][app], "v_cache": cache["v"][app],
                      "cache_len": cache["len"]}
            x, k, v = _attn_block(cfg, params["shared_attn"], x, positions,
                                  **kv)
            new["shared_k"].append(k)
            new["shared_v"].append(v)
    new_cache = None
    if mode != "train":
        new_cache = {key: torch.stack(new[key]) for key in keys}
        if cfg.family == "hybrid":
            new_cache["k"] = torch.stack(new["shared_k"])
            new_cache["v"] = torch.stack(new["shared_v"])
        new_cache["len"] = (
            cache["len"] + positions.shape[-1] if mode == "decode" else
            torch.tensor(x.shape[1], dtype=torch.int32, device=x.device))
    return x, new_cache, aux


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor,
                 dtype) -> torch.Tensor:
    """One-hot-matmul embedding lookup, as the reference's: the backward is
    a matrix product (deterministic), not a scatter-add with atomics. A
    sharded batch builds each shard's rows against the whole table
    (``parallel.ctx.local_linear``)."""
    def lookup(tok, tab):
        onehot = torch.zeros(tok.shape + (tab.shape[0],), dtype=tab.dtype,
                             device=tab.device)
        onehot.scatter_(-1, tok.long()[..., None], 1)
        return (onehot @ tab).to(dtype)
    return local_linear(lookup, tokens, table,
                        {i: i for i in range(tokens.ndim)})


def _embed(cfg, params, tokens, img_embeds=None):
    ct = torch_dtype(cfg.compute_dtype)
    # on a mesh, each rank's one-hot rows are its sequence shard's, not
    # the whole sequence's (a 256000-word vocab's are 26 GB a rank)
    tokens = constrain(tokens, "act_batch", "act_seq")
    x = embed_lookup(params["embed"]["tokens"], tokens, ct)
    if cfg.family == "vlm" and img_embeds is not None:
        x = torch.cat([img_embeds.to(ct), x], dim=1)
    return x


def _unembed(cfg, params, x):
    w = (params["embed"]["tokens"].T if cfg.tie_embeddings
         else params["unembed"])
    logits = local_matmul(x, w.to(x.dtype))
    if cfg.vocab_padded != cfg.vocab:
        # mask (not slice) the padded columns, as the reference does
        mask = torch.arange(cfg.vocab_padded, device=x.device) < cfg.vocab
        logits = torch.where(mask, logits,
                             torch.tensor(-1e30, dtype=logits.dtype,
                                          device=x.device))
    return logits


# ----------------------------- public entry ------------------------------ #

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab_padded: int) -> torch.Tensor:
    """Mean of logsumexp (in float32) less the gold logit. The reference
    contracts the logits with a one-hot of the labels, accumulating in
    float32; with one nonzero term that is the gold logit exactly, which
    the gather reads (its backward writes one value per row). Sharded
    logits give each rank its own tokens' terms (``local_rows``), and
    their mean is one all-reduce over the mesh (``mesh_mean``)."""
    def per_token(lg, lb):
        logz = torch.logsumexp(lg.float(), dim=-1)
        gold = torch.gather(lg, -1, lb.long()[..., None])[..., 0].float()
        return logz - gold
    return mesh_mean(local_rows(per_token, logits, labels))


def loss_fn(cfg, params, batch) -> Tuple[torch.Tensor,
                                         Dict[str, torch.Tensor]]:
    """Next-token cross entropy; batch: tokens (B,S), labels (B,S),
    optional img_embeds (B,P,d)."""
    x = _embed(cfg, params, batch["tokens"], batch.get("img_embeds"))
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)
    x, _, aux = _run_layers(cfg, params, x, positions, None, "train")
    x = common.rmsnorm(x, params["final_norm"])
    if cfg.family == "vlm":
        x = x[:, -batch["tokens"].shape[1]:]       # loss on text tokens only
        # the slice gathers a sharded sequence: shard it again before the
        # logits
        x = constrain(x, "act_batch", "act_seq", None)
    logits = _unembed(cfg, params, x)
    labels = batch["labels"]
    ce = cross_entropy(logits, labels, cfg.vocab_padded)
    total = ce + AUX_LOSS_WEIGHT * aux
    return total, {"ce": ce, "aux": aux}


def prefill(cfg, params, batch, max_len: Optional[int] = None
            ) -> Tuple[torch.Tensor, Any]:
    """Process a prompt; returns (last-position logits, cache)."""
    tokens = batch["tokens"]
    x = _embed(cfg, params, tokens, batch.get("img_embeds"))
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)
    x, cache, _ = _run_layers(cfg, params, x, positions, None, "prefill")
    x = common.rmsnorm(x, params["final_norm"])
    logits = _unembed(cfg, params, x[:, -1:])
    if max_len is not None and max_len > s and cfg.family != "ssm":
        pad = max_len - s
        for key in ("k", "v"):
            cache[key] = torch.nn.functional.pad(
                cache[key], (0, 0, 0, 0, 0, pad))
    return logits[:, 0], cache


def decode_step(cfg, params, cache, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, Any]:
    """One decode step. tokens: (B,) int32; cache from prefill/cache_specs.
    Returns (logits (B, V), new cache)."""
    x = _embed(cfg, params, tokens[:, None])
    positions = torch.reshape(cache["len"], (1,))
    x, cache, _ = _run_layers(cfg, params, x, positions, cache, "decode")
    x = common.rmsnorm(x, params["final_norm"])
    logits = _unembed(cfg, params, x)
    return logits[:, 0], cache


def moe_routing(cfg, params, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, moe_mod.Routing]:
    """The routing that MoE layer 0 takes in a prefill of ``tokens``
    (B, S), its attention half run as ``prefill`` runs it. Returns (the
    residual stream entering its MoE half (B, S, d), ``moe.route_layer``'s
    ``Routing`` of it after ``ln2``)."""
    x = _embed(cfg, params, tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    lp = _unstack(params["layers"])[0]
    x, _, _ = _attn_block(cfg, lp, x, positions)
    h = common.rmsnorm(x, lp["ln2"])
    return x, moe_mod.route_layer(lp["moe"], h, cfg)
