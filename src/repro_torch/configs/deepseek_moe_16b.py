"""DeepSeekMoE-16B [arXiv:2401.06066]: fine-grained experts, 2 shared + 64
routed top-6, first layer dense (d_ff 10944)."""
from repro_torch.configs.base import MoEConfig, ModelConfig, reduced

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe", source="arXiv:2401.06066",
    n_layers=28, d_model=2048, n_heads=16, n_kv=16, d_ff=1408, vocab=102400,
    stages=(("attn+dense", 1), ("attn+moe", 27)),
    moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, d_ff_expert=1408,
                  first_dense=1, d_ff_dense=10944),
)
REDUCED = reduced(CONFIG, stages=(("attn+dense", 1), ("attn+moe", 1)))
