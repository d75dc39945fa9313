"""Yi-9B [arXiv:2403.04652]: llama-architecture dense GQA."""
from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="yi-9b", family="dense", source="arXiv:2403.04652",
    n_layers=48, d_model=4096, n_heads=32, n_kv=4, d_ff=11008, vocab=64000,
    rope_theta=10000.0,
)
REDUCED = reduced(CONFIG)
