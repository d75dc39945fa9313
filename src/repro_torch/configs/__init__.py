"""Configs: AlphaFold's (paper Table I) and the decoder LMs', one module per
architecture, as in the reference's ``configs`` package."""
from __future__ import annotations

import importlib

from repro_torch.configs.alphafold import (  # noqa: F401
    FINE_TUNING, FULL, INITIAL_TRAINING, MINI, SMOKE, AlphaFoldConfig,
    EvoformerConfig, StructureConfig)
from repro_torch.configs.base import (  # noqa: F401
    INPUT_SHAPES, MLAConfig, MoEConfig, ModalityConfig, ModelConfig,
    SSMConfig, ShapeConfig, reduced)

ARCH_MODULES = {
    "qwen2-1.5b": "qwen2_1_5b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "yi-9b": "yi_9b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "musicgen-medium": "musicgen_medium",
    "hymba-1.5b": "hymba_1_5b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "xlstm-125m": "xlstm_125m",
    "gemma3-27b": "gemma3_27b",
    "qwen1.5-32b": "qwen1_5_32b",
}


def list_archs() -> list[str]:
    return list(ARCH_MODULES)


def get_config(arch: str, *, reduced_variant: bool = False) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{ARCH_MODULES[arch]}")
    return mod.REDUCED if reduced_variant else mod.CONFIG
