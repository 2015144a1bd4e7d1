"""qwen1.5-32b — dense GQA LM with QKV bias [hf:Qwen; hf].
64L d_model=5120 40H (GQA kv=40) d_ff=27392 vocab=152064."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b", family="dense", n_layers=64, d_model=5120,
    n_heads=40, n_kv=40, head_dim=128, d_ff=27392, vocab=152064,
    qkv_bias=True, param_dtype="bfloat16")
