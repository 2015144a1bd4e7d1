"""kimi-k2-1t-a32b — trillion-parameter MoE [arXiv:2501.kimi2; unverified].
61L d_model=7168 64H (GQA kv=8) expert d_ff=2048 vocab=163840,
MoE 384 experts top-8. Optimizer: adafactor (AdamW fp32 moments for 1.04T
params exceed the 16 GB/chip v5e budget at 512 chips — see DESIGN.md)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe", n_layers=61, d_model=7168,
    n_heads=64, n_kv=8, head_dim=112, d_ff=2048, vocab=163840,
    moe_experts=384, moe_topk=8, moe_dff=2048, moe_cf=1.25,
    moe_groups=16,    # §Perf H2 iter-3: capacity C ∝ T/E; 16 groups cut
                      # dispatch traffic 2x and dispatch FLOPs 2.1x vs 4
    moe_shard="expert", optimizer="adafactor", param_dtype="bfloat16")
