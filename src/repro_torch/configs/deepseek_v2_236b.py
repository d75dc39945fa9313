"""DeepSeek-V2 236B [arXiv:2405.04434]: MLA (kv_lora=512) + fine-grained MoE
(2 shared + 160 routed, top-6), first layer dense."""
from repro_torch.configs.base import MLAConfig, MoEConfig, ModelConfig, reduced

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe", source="arXiv:2405.04434",
    n_layers=60, d_model=5120, n_heads=128, n_kv=128, d_ff=1536, vocab=102400,
    head_dim=192,  # nope(128)+rope(64) query dim; v_dim=128
    stages=(("mla+dense", 1), ("mla+moe", 59)),
    moe=MoEConfig(n_experts=160, top_k=6, n_shared=2, d_ff_expert=1536,
                  first_dense=1, d_ff_dense=12288),
    mla=MLAConfig(q_lora=1536, kv_lora=512, rope_dim=64, nope_dim=128,
                  v_dim=128),
)
REDUCED = reduced(CONFIG, stages=(("mla+dense", 1), ("mla+moe", 1)))
