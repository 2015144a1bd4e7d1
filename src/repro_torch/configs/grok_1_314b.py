"""grok-1-314b — 8-expert top-2 MoE [hf:xai-org/grok-1; unverified].
64L d_model=6144 48H (GQA kv=8) expert d_ff=32768 vocab=131072.
8 experts < 16 model shards -> shard the expert FFN dim (moe_shard='ffn')."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe", n_layers=64, d_model=6144,
    n_heads=48, n_kv=8, head_dim=128, d_ff=32768, vocab=131072,
    moe_experts=8, moe_topk=2, moe_dff=32768, moe_cf=1.25,
    moe_groups=16,    # §Perf H2 carry-over: -10% memory / -19% collective
    moe_shard="ffn", param_dtype="bfloat16",
    rule_overrides={"experts": None, "expert_ffn": "model"})
