"""falcon-mamba-7b — attention-free Mamba-1 LM [arXiv:2410.05355;
unverified]. 64L d_model=4096 d_ff=0 vocab=65024, ssm_state=16."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm", n_layers=64, d_model=4096,
    n_heads=1, n_kv=1, head_dim=64, d_ff=0, vocab=65024,
    ssm_state=16, ssm_expand=2, ssm_conv=4, mamba_version=1,
    ssm_chunk=32,     # §Perf H1 iter-3: 8% less HBM traffic than Q=128
    param_dtype="bfloat16")
