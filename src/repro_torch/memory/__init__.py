"""Memory planning: the AutoChunk activation-memory planner of the
Evoformer and the serving engine's decoder block planner
(``repro_torch.memory.autochunk``)."""
from repro_torch.memory.autochunk import (  # noqa: F401
    AdmissionCheck,
    ChunkPlan,
    DecoderPlan,
    apply_plan,
    attention_transient_bytes,
    check_decoder_admission,
    decoder_attention_bytes,
    evoformer_peak_bytes,
    modeled_evoformer_peak,
    opm_transient_bytes,
    outside_block_bytes,
    plan_decoder_blocks,
    plan_evoformer_chunks,
    resolve_evoformer_config,
    triangle_transient_bytes,
)
