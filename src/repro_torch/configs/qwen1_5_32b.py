"""Qwen1.5-32B [hf:Qwen/Qwen1.5-0.5B family card]: dense MHA with QKV bias."""
from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="qwen1.5-32b", family="dense", source="hf:Qwen/Qwen1.5-0.5B",
    n_layers=64, d_model=5120, n_heads=40, n_kv=40, d_ff=27392, vocab=152064,
    qkv_bias=True, rope_theta=1e6,
)
REDUCED = reduced(CONFIG)
