"""Hymba-1.5B [arXiv:2411.13676]: hybrid-head blocks — attention and Mamba
heads in parallel within each layer; full attention at 3 layers (first,
middle, last), sliding-window elsewhere; ssm_state=16."""
from repro_torch.configs.base import ModelConfig, SSMConfig, reduced

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid", source="arXiv:2411.13676",
    n_layers=32, d_model=1600, n_heads=25, n_kv=5, d_ff=5504, vocab=32001,
    sliding_window=1024, subquadratic=True,
    stages=(("hymba_full", 1), ("hymba", 14), ("hymba_full", 1),
            ("hymba", 15), ("hymba_full", 1)),
    ssm=SSMConfig(state_dim=16, expand=2, conv_width=4),
)
REDUCED = reduced(CONFIG, stages=(("hymba_full", 1), ("hymba", 1)))
