"""int8 error-feedback gradient compression (port of
``repro.optim.compression``, DESIGN.md §9).

Quantizing grads to int8 with per-(leading-slice) scales cuts the bytes of
a gradient collective 2x (vs bf16) / 4x (vs f32); the quantization
residual is fed back into the next step's grads (error feedback). The EF
buffer rides in the train state (``train_lib.state_specs(...,
compress=True)``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from ..models import spec as spec_mod
from ..models.spec import tree_map


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row (leading-axis) int8 quantization."""
    xf = x.float()
    red = tuple(range(1, xf.ndim)) or (0,)
    scale = torch.amax(torch.abs(xf), dim=red, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def ef_state_specs(param_specs) -> Any:
    """Error-feedback residual buffer per param (same shape, bf16)."""
    return spec_mod.map_specs(
        lambda p, s: dataclasses.replace(s, init="zeros", dtype="bfloat16"),
        param_specs)


def _one(g: torch.Tensor, e: torch.Tensor):
    gf = g.float() + e.float()
    q, scale = quantize_int8(gf)
    deq = dequantize_int8(q, scale)
    resid = (gf - deq).to(torch.bfloat16)
    return deq.to(g.dtype), resid


def compress_grads(grads: Any, ef: Any) -> Tuple[Any, Any]:
    """Apply EF + int8 round-trip to every grad leaf. Returns
    (compressed-dequantized grads, new EF residuals): the values an int8
    collective (quantize -> all-reduce with f32 accumulation ->
    dequantize) would deliver."""
    out = tree_map(_one, grads, ef)          # leaves: (grad, residual)
    return _pick(out, 0), _pick(out, 1)


def _pick(tree, i):
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]


def wire_bytes(param_specs, dtype_bytes: int = 4) -> Tuple[int, int]:
    """(uncompressed, compressed) gradient bytes per sync for reporting."""
    n = spec_mod.count_params(param_specs)
    comp = n  # int8 payload
    # + one f32 scale per leading row — negligible, ignore for the headline
    return n * dtype_bytes, comp
