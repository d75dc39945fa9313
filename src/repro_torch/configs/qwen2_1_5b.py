"""Qwen2-1.5B [arXiv:2407.10671]: dense GQA decoder with QKV bias."""
from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="qwen2-1.5b", family="dense", source="arXiv:2407.10671",
    n_layers=28, d_model=1536, n_heads=12, n_kv=2, d_ff=8960, vocab=151936,
    qkv_bias=True, rope_theta=1e6, tie_embeddings=True,
)
REDUCED = reduced(CONFIG)
