"""LLaVA-NeXT (Mistral-7B backbone) [hf:llava-hf/llava-v1.6-mistral-7b-hf].

VLM: the SigLIP/CLIP vision tower + projector are the allowed STUB —
input_specs() supplies post-projector patch embeddings (anyres tiling yields
up to 2880 patch tokens) of shape (B, P, d_model); this config is the
language backbone that consumes them.
"""
from repro_torch.configs.base import ModelConfig, ModalityConfig, reduced

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
    n_layers=32, d_model=4096, n_heads=32, n_kv=8, d_ff=14336, vocab=32000,
    rope_theta=1e6,
    modality=ModalityConfig(kind="vision", n_prefix_tokens=2880,
                            embed_dim=4096),
)
REDUCED = reduced(CONFIG)
