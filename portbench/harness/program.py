"""The system under test, built from a configuration file: the port's
``AlphaFoldConfig`` and a batch of its features on the device."""
from __future__ import annotations

import numpy as np
import torch


def port_config(cfg: dict):
    """The port's ``AlphaFoldConfig`` of a ``configs/*.json`` file."""
    from repro_torch.configs.alphafold import (AlphaFoldConfig,
                                               EvoformerConfig,
                                               StructureConfig)

    evo = EvoformerConfig(
        d_msa=cfg["d_msa"], d_pair=cfg["d_pair"], msa_heads=cfg["msa_heads"],
        pair_heads=cfg["pair_heads"], head_dim=cfg["head_dim"],
        opm_dim=cfg["opm_dim"], tri_mult_dim=cfg["tri_mult_dim"],
        transition_factor=cfg["transition_factor"],
        dropout_msa=cfg["dropout_msa"], dropout_pair=cfg["dropout_pair"],
        n_blocks=cfg["n_blocks"])
    structure = StructureConfig(
        c_s=cfg["c_s"], c_z=cfg["d_pair"], n_heads=cfg["ipa_heads"],
        c_hidden=cfg["ipa_c_hidden"], n_qk_points=cfg["n_qk_points"],
        n_v_points=cfg["n_v_points"], n_iterations=cfg["n_iterations"],
        trans_scale=cfg["trans_scale"])
    return AlphaFoldConfig(evoformer=evo, structure=structure,
                           n_recycle=cfg["n_recycle"],
                           recycle_bins=cfg["recycle_bins"],
                           compute_dtype=getattr(torch, cfg["compute_dtype"]))


def to_device(batch: dict[str, np.ndarray], device) -> dict:
    """Features as tensors on ``device``: integer arrays stay integer."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def release(device) -> None:
    """Hand the allocator's free blocks back after the program's state is
    dropped, so the reference that follows has the card."""
    import gc

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
