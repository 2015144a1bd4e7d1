"""zamba2-7b — Mamba-2 blocks + SHARED attention block [arXiv:2411.15242;
unverified]. 81L d_model=3584 32H (MHA kv=32) d_ff=14336 vocab=32000,
ssm_state=64. The shared transformer block is applied after every
`attn_every` mamba blocks with reused weights (per-application KV cache)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid", n_layers=81, d_model=3584,
    n_heads=32, n_kv=32, head_dim=112, d_ff=14336, vocab=32000,
    ssm_state=64, ssm_expand=2, ssm_conv=4, mamba_version=2, attn_every=6,
    param_dtype="bfloat16")
