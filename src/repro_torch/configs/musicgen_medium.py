"""MusicGen-medium [arXiv:2306.05284]: decoder-only transformer over EnCodec
tokens. The EnCodec audio codec (conv frontend) is the allowed STUB — the
pipeline supplies token ids / frame embeddings directly; this is the LM."""
from repro_torch.configs.base import ModalityConfig, ModelConfig, reduced

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio", source="arXiv:2306.05284",
    n_layers=48, d_model=1536, n_heads=24, n_kv=24, d_ff=6144, vocab=2048,
    norm="layernorm", act="gelu",
    modality=ModalityConfig(kind="audio", n_prefix_tokens=0, embed_dim=1536),
)
REDUCED = reduced(CONFIG)
