"""whisper-small — enc-dec audio backbone [arXiv:2212.04356; unverified].
12L d_model=768 12H (kv=12) d_ff=3072 vocab=51865. Conv/mel frontend is a
STUB: input_specs() provides precomputed frame embeddings (B, 1500, d)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="encdec", n_layers=12, d_model=768,
    n_heads=12, n_kv=12, head_dim=64, d_ff=3072, vocab=51865,
    enc_layers=12, enc_len=1500, param_dtype="bfloat16")
