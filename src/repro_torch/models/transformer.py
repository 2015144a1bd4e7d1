"""Decoder-only LM of the dense and vlm families (port of
``repro.models.transformer``), with the stacked-layer loop + remat, KV
caches, prefill and decode steps.

One code path serves minitron-4b, granite-3-8b, qwen1.5-32b, yi-9b and
pixtral-12b (text backbone + stub image-embedding prefix). The reference's
``moe``, ``ssm`` and ``hybrid`` families raise ``NotImplementedError``
naming their ROADMAP items. The reference's ``constrain`` calls (activation
sharding constraints around each layer) are no-ops on one card and are
dropped; they stood at the entry and exit of ``_run_layers``' body.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from . import common
from .spec import ParamSpec, stack_layers, torch_dtype

AUX_LOSS_WEIGHT = 0.01

# the reference's families that wait for a later slice, by ROADMAP item
NOT_PORTED = {
    "moe": "models/moe.py (ROADMAP Queue 1 item 6: kimi-k2, grok-1)",
    "ssm": "models/ssm.py (ROADMAP Queue 1 item 7: falcon-mamba, zamba2)",
    "hybrid": "models/ssm.py and the hybrid path (ROADMAP Queue 1 item 7: "
              "zamba2)",
    "encdec": "models/encdec.py (ROADMAP Queue 1 item 8: whisper)",
}


def check_family(cfg) -> None:
    """Raise for a family whose modules are not ported yet."""
    if cfg.family in NOT_PORTED:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} needs "
            f"{NOT_PORTED[cfg.family]}, not ported yet; the port runs "
            "'dense' and 'vlm'")
    if cfg.family not in ("dense", "vlm"):
        raise ValueError(f"unknown family {cfg.family!r}")


# ------------------------------ param specs ------------------------------ #

def _layer_specs(cfg) -> dict:
    check_family(cfg)
    return {
        "ln1": common.rmsnorm_spec(cfg.d_model, cfg.param_dtype),
        "attn": common.attn_specs(cfg),
        "ln2": common.rmsnorm_spec(cfg.d_model, cfg.param_dtype),
        "mlp": common.mlp_specs(cfg),
    }


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
    return specs


# ------------------------------- caches ---------------------------------- #

def cache_specs(cfg, batch: int, max_len: int) -> dict:
    """Cache layout for serving."""
    check_family(cfg)
    ct = cfg.compute_dtype
    kv, hd = cfg.n_kv, cfg.head_dim
    return {
        "k": ParamSpec((cfg.n_layers, batch, max_len, kv, hd),
                       ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
                       dtype=ct),
        "v": ParamSpec((cfg.n_layers, batch, max_len, kv, hd),
                       ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
                       dtype=ct),
        "len": ParamSpec((), (), init="zeros", dtype="int32"),
    }


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
    if mode == "decode":
        x, k, v = _attn_block(cfg, p, x, positions,
                              k_cache=cache_slice["k"],
                              v_cache=cache_slice["v"],
                              cache_len=cache_slice["len"])
        new_cache = {"k": k, "v": v, "len": cache_slice["len"]}
    else:
        x, k, v = _attn_block(cfg, p, x, positions)
        new_cache = {"k": k, "v": v} if mode == "prefill" else None

    h = common.rmsnorm(x, p["ln2"])
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


def _run_layers(cfg, params, x, positions, cache, mode: str):
    """The loop over the layer stack (the reference's ``lax.scan``); each
    layer under ``torch.utils.checkpoint`` when ``cfg.remat`` and grads
    are on (the reference's ``jax.checkpoint`` of the scan body). Returns
    (x, new_cache, aux_sum)."""
    check_family(cfg)
    layers = _unstack(params["layers"])
    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_k, new_v = [], []
    for i, lp in enumerate(layers):
        cs = None
        if mode == "decode":
            cs = {"k": cache["k"][i], "v": cache["v"][i],
                  "len": cache["len"]}
        if remat:
            x, ncs, a = checkpoint(_mixer_block, cfg, lp, x, positions, cs,
                                   mode, use_reentrant=False)
        else:
            x, ncs, a = _mixer_block(cfg, lp, x, positions, cs, mode)
        aux = aux + a
        if mode != "train":
            new_k.append(ncs["k"])
            new_v.append(ncs["v"])
    new_cache = None
    if mode == "decode":
        new_cache = {"k": torch.stack(new_k), "v": torch.stack(new_v),
                     "len": cache["len"] + positions.shape[-1]}
    elif mode == "prefill":
        new_cache = {"k": torch.stack(new_k), "v": torch.stack(new_v),
                     "len": torch.tensor(x.shape[1], dtype=torch.int32,
                                         device=x.device)}
    return x, new_cache, aux


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor,
                 dtype) -> torch.Tensor:
    """One-hot-matmul embedding lookup, as the reference's: the backward is
    a matrix product (deterministic), not a scatter-add with atomics."""
    v = table.shape[0]
    onehot = torch.zeros(tokens.shape + (v,), dtype=table.dtype,
                         device=table.device)
    onehot.scatter_(-1, tokens.long()[..., None], 1)
    return (onehot @ table).to(dtype)


def _embed(cfg, params, tokens, img_embeds=None):
    ct = torch_dtype(cfg.compute_dtype)
    x = embed_lookup(params["embed"]["tokens"], tokens, ct)
    if cfg.family == "vlm" and img_embeds is not None:
        x = torch.cat([img_embeds.to(ct), x], dim=1)
    return x


def _unembed(cfg, params, x):
    w = (params["embed"]["tokens"].T if cfg.tie_embeddings
         else params["unembed"])
    logits = x @ w.to(x.dtype)
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
    the gather reads (its backward writes one value per row)."""
    logz = torch.logsumexp(logits.float(), dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0].float()
    return torch.mean(logz - gold)


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
    if max_len is not None and max_len > s:
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
