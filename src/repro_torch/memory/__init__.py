"""Memory planning: the AutoChunk activation-memory planner of the
Evoformer (``repro_torch.memory.autochunk``)."""
from repro_torch.memory.autochunk import (  # noqa: F401
    ChunkPlan,
    apply_plan,
    attention_transient_bytes,
    evoformer_peak_bytes,
    modeled_evoformer_peak,
    opm_transient_bytes,
    outside_block_bytes,
    plan_evoformer_chunks,
    resolve_evoformer_config,
    triangle_transient_bytes,
)
