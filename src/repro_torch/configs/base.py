"""Model / run configuration dataclasses + the assigned input-shape grid
(a copy of ``repro.configs.base``; the port imports nothing of ``repro``)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 1e4
    tie_embeddings: bool = False
    # MoE
    moe_experts: int = 0
    moe_topk: int = 0
    moe_dff: int = 0
    moe_cf: float = 2.0            # capacity factor
    moe_groups: int = 4            # GShard token groups per device-batch
    moe_shard: str = "expert"      # 'expert' (EP) | 'ffn' (TP over expert dff)
    # SSM (mamba)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_heads: int = 0             # mamba2 heads (0 -> d_inner // 64)
    mamba_version: int = 1
    # hybrid (zamba2)
    attn_every: int = 6
    # enc-dec (whisper)
    enc_layers: int = 0
    enc_len: int = 1500
    # vlm (pixtral)
    vlm_prefix: int = 0            # image-token prefix length (stub embeds)
    # numerics / execution
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True
    attn_chunk: int = 1024         # kv-chunked attention above this seq len
    ssm_chunk: int = 128
    optimizer: str = "adamw"       # adamw | adafactor
    # per-arch logical-axis rule overrides (e.g. grok: ffn-sharded experts)
    rule_overrides: Dict[str, Optional[str]] = field(default_factory=dict)

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.family in ("ssm", "hybrid") and self.ssm_heads == 0:
            d_inner = self.d_model * self.ssm_expand
            object.__setattr__(self, "ssm_heads", max(1, d_inner // 64))

    @property
    def d_inner(self) -> int:
        return self.d_model * self.ssm_expand

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to a multiple of 256 for sharding (standard
        Megatron-style padding; loss slices logits back to `vocab`)."""
        return -(-self.vocab // 256) * 256

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        return self.replace(
            n_layers=max(2, min(4, self.n_layers)),
            d_model=64,
            n_heads=4, n_kv=min(self.n_kv, 2) if self.n_kv else 2,
            head_dim=16,
            d_ff=128, vocab=256,
            moe_experts=min(self.moe_experts, 4) or self.moe_experts,
            moe_topk=min(self.moe_topk, 2) or self.moe_topk,
            moe_dff=64 if self.moe_dff else 0,
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            ssm_heads=2 if self.family in ("ssm", "hybrid") else 0,
            enc_layers=2 if self.enc_layers else 0,
            enc_len=32 if self.enc_layers else 0,
            vlm_prefix=8 if self.vlm_prefix else 0,
            attn_every=2,
            param_dtype="float32", compute_dtype="float32",
            attn_chunk=64, ssm_chunk=16)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # 'train' | 'prefill' | 'decode'


# The assigned input-shape grid (one set for all 10 LM archs).
SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# long_500k needs sub-quadratic attention state; only SSM/hybrid archs run it
# (DESIGN.md §9) — pure full-attention archs record a documented skip.
LONG_CONTEXT_FAMILIES = ("ssm", "hybrid")


def cell_is_runnable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    if shape.name == "long_500k" and cfg.family not in LONG_CONTEXT_FAMILIES:
        return False, ("skipped: pure full-attention arch at 524288-token KV "
                       "decode (sub-quadratic state required; see DESIGN.md)")
    return True, ""
