"""xLSTM-125M [arXiv:2405.04517]: sLSTM + mLSTM blocks (no separate FFN,
d_ff=0); attention-free => paper's axis-swap DAP inapplicable (DESIGN.md)."""
from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="xlstm-125m", family="ssm", source="arXiv:2405.04517",
    n_layers=12, d_model=768, n_heads=4, n_kv=4, d_ff=0, vocab=50304,
    subquadratic=True,
    stages=(("mlstm", 5), ("slstm", 1), ("mlstm", 5), ("slstm", 1)),
)
REDUCED = reduced(CONFIG, stages=(("mlstm", 1), ("slstm", 1)))
