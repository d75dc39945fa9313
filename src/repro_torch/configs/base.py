"""Decoder-LM config dataclasses and the assigned input shapes.

The port's own copy of the reference's ``configs/base.py``: the same
dataclasses, fields, defaults and ``reduced`` shrink, so a config compares
equal to the reference's field for field (``dataclasses.asdict``). Every
architecture has one module in this package defining
``CONFIG = ModelConfig(...)`` (the assigned numbers, source cited) and
``REDUCED = reduced(CONFIG)``, a same-family shrink (<=2 layers,
d_model<=512, <=4 experts) that the CPU tests run. The comments on the
perf levers name the reference's TPU mesh, where they were tuned.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    n_shared: int = 0
    d_ff_expert: int = 0
    first_dense: int = 0          # leading dense layers (DeepSeek: 1)
    capacity_factor: float = 1.25
    aux_weight: float = 0.001
    d_ff_dense: int = 0           # d_ff of the leading dense layers
    # dispatch groups: capacity selection is done per token-group so routing
    # metadata never crosses shards (set to the DAP degree by the sharding
    # plan; 1 = single global group).
    n_groups: int = 1


@dataclass(frozen=True)
class MLAConfig:
    q_lora: int = 1536
    kv_lora: int = 512
    rope_dim: int = 64
    nope_dim: int = 128
    v_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 16
    expand: int = 2
    conv_width: int = 4
    dt_rank: int = 0              # 0 -> ceil(d_model/16)


@dataclass(frozen=True)
class ModalityConfig:
    kind: str                     # "vision" | "audio"
    n_prefix_tokens: int          # patch/frame embeddings prepended to text
    embed_dim: int                # dim of the (stub) frontend output


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    source: str                   # citation from the assignment
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    act: str = "swiglu"           # swiglu | gelu
    tie_embeddings: bool = False
    sliding_window: int = 0       # 0 -> full attention
    # layer pattern: tuple of (kind, count); kinds: attn, swa, mlstm, slstm,
    # hymba, hymba_full. Empty -> ("attn", n_layers).
    stages: tuple = ()
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    modality: Optional[ModalityConfig] = None
    # True when the arch supports the long_500k shape (sub-quadratic path).
    subquadratic: bool = False
    # --- attention execution policy (perf levers; see EXPERIMENTS.md §Perf).
    # attn_q_block=0 -> single full-length q block (no q scan: under DAP the
    # q axis is already sharded, so q-blocking only causes GSPMD resharding).
    attn_q_block: int = 512
    attn_kv_block: int = 1024
    # gather KV once per layer (replicated over 'model') before the blockwise
    # scan, instead of letting GSPMD re-gather inside every scan step.
    gather_kv: bool = False
    # store decode KV caches as int8 with per-(layer,head) scales (beyond-
    # paper: halves cache bytes; needed for qwen1.5-32b decode_32k to fit).
    kv_cache_int8: bool = False
    # bf16 AdamW moments (beyond-paper: 12 -> 8 bytes/param of sharded state;
    # needed for deepseek-v2-236b train_4k to fit the 256-chip mesh).
    opt_state_bf16: bool = False
    # serve-time: replicate (bf16) params across the mesh instead of ZeRO
    # sharding — kills the per-layer weight all-gathers that dominate the
    # decode collective term for small models (paper-faithful DAP semantics:
    # full params per device).
    serve_replicate_params: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def resolved_stages(self) -> tuple:
        return self.stages or (("attn", self.n_layers),)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Same-family smoke-test shrink: <=2 layers, d_model<=512, <=4 experts."""
    changes: dict = dict(
        n_layers=2,
        d_model=min(cfg.d_model, 128),
        n_heads=min(cfg.n_heads, 4),
        n_kv=min(cfg.n_kv, 2),
        d_ff=min(cfg.d_ff, 256) if cfg.d_ff else 0,
        vocab=min(cfg.vocab, 512),
        head_dim=32 if cfg.head_dim else 0,
    )
    if cfg.n_kv == cfg.n_heads:  # keep MHA archs MHA
        changes["n_kv"] = changes["n_heads"]
    if cfg.moe:
        changes["moe"] = dataclasses.replace(
            cfg.moe, n_experts=4, top_k=2, n_shared=min(cfg.moe.n_shared, 1),
            d_ff_expert=64, first_dense=min(cfg.moe.first_dense, 1),
            d_ff_dense=128 if cfg.moe.d_ff_dense else 0,
        )
    if cfg.mla:
        changes["mla"] = MLAConfig(q_lora=64, kv_lora=32, rope_dim=16,
                                   nope_dim=32, v_dim=32)
    if cfg.ssm:
        changes["ssm"] = dataclasses.replace(cfg.ssm, state_dim=8)
    if cfg.modality:
        changes["modality"] = dataclasses.replace(
            cfg.modality, n_prefix_tokens=8, embed_dim=changes["d_model"])
    if cfg.sliding_window:
        changes["sliding_window"] = 16
    if cfg.stages:
        # shrink the pattern to 2 layers keeping kind diversity
        kinds = []
        for kind, cnt in cfg.stages:
            if kind not in kinds:
                kinds.append(kind)
        kinds = kinds[:2] or ["attn"]
        if len(kinds) == 1:
            kinds = kinds * 2
        changes["stages"] = tuple((k, 1) for k in kinds)
    changes.update(overrides)
    return dataclasses.replace(cfg, **changes)
