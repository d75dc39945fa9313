"""Gemma-3-27B [hf:google/gemma-3-1b-pt family card]: 5:1 local:global
attention (window 1024), qk-norm, head_dim 128, 128k->500k windowed
long-context variant."""
from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="gemma3-27b", family="dense", source="hf:google/gemma-3-1b-pt",
    n_layers=62, d_model=5376, n_heads=32, n_kv=16, d_ff=21504,
    vocab=262144, head_dim=128, qk_norm=True, rope_theta=1e6,
    sliding_window=1024, subquadratic=True, tie_embeddings=True,
    stages=(("swa", 5), ("attn", 1)) * 10 + (("swa", 2),),
)
REDUCED = reduced(CONFIG, stages=(("swa", 1), ("attn", 1)))
