"""pixtral-12b — pixtral-ViT + mistral-nemo backbone [hf:mistralai;
unverified]. 40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072.
Vision frontend is a STUB: input_specs() provides precomputed patch
embeddings (vlm_prefix tokens) prepended to the text sequence."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b", family="vlm", n_layers=40, d_model=5120,
    n_heads=32, n_kv=8, head_dim=128, d_ff=14336, vocab=131072,
    vlm_prefix=1024, rope_theta=1e6, param_dtype="bfloat16")
