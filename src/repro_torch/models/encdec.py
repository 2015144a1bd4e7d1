"""Whisper-small encoder-decoder backbone (port of ``repro.models.encdec``).

The conv/mel frontend is a stub, as in the reference: ``input_specs()``
supplies precomputed frame embeddings (B, enc_len, d_model). The
reference's deviations from upstream Whisper hold here too: rotary
positions instead of learned or sinusoidal embeddings, RMSNorm, the gated
MLP of the shared block library. Decode uses a self-attention KV cache
plus the cross-attention K/V computed once at prefill. The reference's
``constrain`` calls stand at each layer's entry, in both bodies.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..parallel.ctx import constrain, local_einsum, local_matmul
from . import common
from .spec import ParamSpec, stack_layers, torch_dtype
from .transformer import (_unstack, _update_cache, cross_entropy,
                          embed_lookup, layer_call)


def _enc_layer_specs(cfg) -> dict:
    return {
        "ln1": common.rmsnorm_spec(cfg.d_model, cfg.param_dtype),
        "attn": common.attn_specs(cfg),
        "ln2": common.rmsnorm_spec(cfg.d_model, cfg.param_dtype),
        "mlp": common.mlp_specs(cfg),
    }


def _dec_layer_specs(cfg) -> dict:
    return {
        "ln1": common.rmsnorm_spec(cfg.d_model, cfg.param_dtype),
        "attn": common.attn_specs(cfg),
        "lnx": common.rmsnorm_spec(cfg.d_model, cfg.param_dtype),
        "xattn": common.attn_specs(cfg, cross=True),
        "ln2": common.rmsnorm_spec(cfg.d_model, cfg.param_dtype),
        "mlp": common.mlp_specs(cfg),
    }


def build_specs(cfg) -> dict:
    return {
        "embed": {"tokens": ParamSpec((cfg.vocab_padded, cfg.d_model),
                                      ("vocab", "embed"),
                                      dtype=cfg.param_dtype)},
        "enc_layers": stack_layers(_enc_layer_specs(cfg), cfg.enc_layers),
        "enc_norm": common.rmsnorm_spec(cfg.d_model, cfg.param_dtype),
        "dec_layers": stack_layers(_dec_layer_specs(cfg), cfg.n_layers),
        "final_norm": common.rmsnorm_spec(cfg.d_model, cfg.param_dtype),
        "unembed": ParamSpec((cfg.d_model, cfg.vocab_padded),
                             ("embed", "vocab"), dtype=cfg.param_dtype),
    }


def cache_specs(cfg, batch: int, max_len: int) -> dict:
    ct = cfg.compute_dtype
    kv, hd = cfg.n_kv, cfg.head_dim
    return {
        "k": ParamSpec((cfg.n_layers, batch, max_len, kv, hd),
                       ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
                       dtype=ct),
        "v": ParamSpec((cfg.n_layers, batch, max_len, kv, hd),
                       ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
                       dtype=ct),
        "xk": ParamSpec((cfg.n_layers, batch, cfg.enc_len, kv, hd),
                        ("layers", "batch", None, "kv_heads", "head_dim"),
                        dtype=ct),
        "xv": ParamSpec((cfg.n_layers, batch, cfg.enc_len, kv, hd),
                        ("layers", "batch", None, "kv_heads", "head_dim"),
                        dtype=ct),
        "len": ParamSpec((), (), init="zeros", dtype="int32"),
    }


def _loop(cfg, body, x, layers, caches=None):
    """The reference's ``scan_or_loop`` over stacked layers, each layer
    through ``transformer.layer_call``. Returns (x, the layers' second
    outputs)."""
    outs = []
    for i, lp in enumerate(_unstack(layers)):
        cs = None if caches is None else {k: v[i] for k, v in caches.items()}
        x, y = layer_call(cfg, body, x, lp, cs)
        outs.append(y)
    return x, outs


def encode(cfg, params, frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, enc_len, d_model) stub embeddings -> encoder output."""
    x = frames.to(torch_dtype(cfg.compute_dtype))
    positions = torch.arange(x.shape[1], device=x.device)

    def body(h, lp, _):
        h = constrain(h, "act_batch", "act_seq", None)
        a = common.rmsnorm(h, lp["ln1"])
        q, k, v = common.qkv_proj(lp["attn"], a, cfg)
        q = common.rotary(q, positions, cfg.rope_theta)
        k = common.rotary(k, positions, cfg.rope_theta)
        y = common.gqa_attention(q, k, v, causal=False, chunk=0)
        h = h + common.attn_out(lp["attn"], y)
        m = common.rmsnorm(h, lp["ln2"])
        h = h + common.mlp(lp["mlp"], m, act="gelu")
        return h, None

    x, _ = _loop(cfg, body, x, params["enc_layers"])
    return common.rmsnorm(x, params["enc_norm"])


def _cross_kv(cfg, lp, enc_out):
    ct = enc_out.dtype
    k = local_einsum("btd,dhk->bthk", enc_out, lp["xattn"]["wk"].to(ct))
    v = local_einsum("btd,dhk->bthk", enc_out, lp["xattn"]["wv"].to(ct))
    return k, v


def _decoder(cfg, params, tokens, positions, enc_out=None, cache=None,
             mode: str = "train"):
    x = embed_lookup(params["embed"]["tokens"], tokens,
                     torch_dtype(cfg.compute_dtype))

    def body(h, lp, cs):
        h = constrain(h, "act_batch", "act_seq", None)
        # self attention (causal / cached)
        a = common.rmsnorm(h, lp["ln1"])
        q, k, v = common.qkv_proj(lp["attn"], a, cfg)
        q = common.rotary(q, positions, cfg.rope_theta)
        k = common.rotary(k, positions, cfg.rope_theta)
        if mode == "decode":
            kc = _update_cache(cs["k"], k, cs["len"])
            vc = _update_cache(cs["v"], v, cs["len"])
            y = common.gqa_attention(q, kc, vc, causal=False,
                                     q_offset=cs["len"],
                                     kv_len=cs["len"] + 1, chunk=0)
            new_cs = {"k": kc, "v": vc}
        else:
            y = common.gqa_attention(q, k, v, causal=True,
                                     chunk=cfg.attn_chunk
                                     if q.shape[1] > cfg.attn_chunk else 0)
            new_cs = {"k": k, "v": v} if mode == "prefill" else None
        h = h + common.attn_out(lp["attn"], y)
        # cross attention
        a = common.rmsnorm(h, lp["lnx"])
        qx = local_einsum("bsd,dhk->bshk", a,
                          lp["xattn"]["wq"].to(a.dtype))
        if mode == "decode":
            xk, xv = cs["xk"], cs["xv"]
        else:
            xk, xv = _cross_kv(cfg, lp, enc_out)
        yx = common.gqa_attention(qx, xk, xv, causal=False, chunk=0)
        h = h + common.attn_out(lp["xattn"], yx)
        if new_cs is not None:
            new_cs.update({"xk": xk, "xv": xv})
        # mlp
        m = common.rmsnorm(h, lp["ln2"])
        h = h + common.mlp(lp["mlp"], m, act="gelu")
        return h, new_cs

    caches = None
    if mode == "decode":
        caches = {"k": cache["k"], "v": cache["v"], "xk": cache["xk"],
                  "xv": cache["xv"],
                  "len": cache["len"].expand(cfg.n_layers)}
    x, outs = _loop(cfg, body, x, params["dec_layers"], caches)
    x = common.rmsnorm(x, params["final_norm"])
    logits = local_matmul(x, params["unembed"].to(x.dtype))
    if cfg.vocab_padded != cfg.vocab:
        mask = torch.arange(cfg.vocab_padded, device=x.device) < cfg.vocab
        logits = torch.where(mask, logits,
                             torch.tensor(-1e30, dtype=logits.dtype,
                                          device=x.device))
    new_cs = None
    if mode != "train":
        new_cs = {key: torch.stack([o[key] for o in outs])
                  for key in ("k", "v", "xk", "xv")}
    return logits, new_cs


def loss_fn(cfg, params, batch) -> Tuple[torch.Tensor,
                                         Dict[str, torch.Tensor]]:
    enc_out = encode(cfg, params, batch["frames"])
    s = batch["tokens"].shape[1]
    positions = torch.arange(s, device=enc_out.device)
    logits, _ = _decoder(cfg, params, batch["tokens"], positions,
                         enc_out=enc_out, mode="train")
    ce = cross_entropy(logits, batch["labels"], cfg.vocab_padded)
    return ce, {"ce": ce, "aux": ce.new_zeros((), dtype=torch.float32)}


def prefill(cfg, params, batch, max_len=None) -> Tuple[torch.Tensor, Any]:
    enc_out = encode(cfg, params, batch["frames"])
    s = batch["tokens"].shape[1]
    positions = torch.arange(s, device=enc_out.device)
    logits, cache = _decoder(cfg, params, batch["tokens"], positions,
                             enc_out=enc_out, mode="prefill")
    cache["len"] = torch.tensor(s, dtype=torch.int32, device=logits.device)
    if max_len is not None and max_len > s:
        for key in ("k", "v"):
            cache[key] = torch.nn.functional.pad(
                cache[key], (0, 0, 0, 0, 0, max_len - s))
    return logits[:, -1], cache


def decode_step(cfg, params, cache, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, Any]:
    positions = torch.reshape(cache["len"], (1,))
    logits, new_cache = _decoder(cfg, params, tokens[:, None], positions,
                                 cache=cache, mode="decode")
    new_cache["len"] = cache["len"] + 1
    return logits[:, 0], new_cache
