"""End-to-end AlphaFold-2 folding inference: embedders, recycling, the
Evoformer trunk, the structure module and the heads.

Left out of this port for now: AutoChunk (the reference's
``resolve_evoformer_config``), whose knobs change memory and not numbers,
the training loss, and dropout. The recycling loop is a Python loop.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.alphafold import AlphaFoldConfig
from repro_torch.core.evoformer import evoformer_stack, init_evoformer_stack
from repro_torch.core.structure import init_structure_module, structure_module
from repro_torch.data.synthetic import N_AA, N_MSA_TOK
from repro_torch.layers.norms import init_layer_norm, layer_norm
from repro_torch.layers.params import Params, dense, init_dense

RELPOS_K = 32
N_DIST_BINS = 64


def init_alphafold(generator: torch.Generator, cfg: AlphaFoldConfig) -> Params:
    """Fresh parameters on the CPU, with the reference's shapes and scheme:
    truncated-normal fan-in weights, zero-initialised output projections,
    gate biases of one."""
    d_m, d_z = cfg.d_msa, cfg.d_pair
    g = generator
    return {
        "msa_embed": init_dense(g, N_MSA_TOK, d_m, bias=True),
        "target_embed_m": init_dense(g, N_AA, d_m, bias=True),
        "left_embed": init_dense(g, N_AA, d_z, bias=True),
        "right_embed": init_dense(g, N_AA, d_z, bias=True),
        "relpos_embed": init_dense(g, 2 * RELPOS_K + 1, d_z, bias=True),
        "recycle": {
            "ln_m": init_layer_norm(d_m),
            "ln_z": init_layer_norm(d_z),
            "dist_embed": init_dense(g, cfg.recycle_bins, d_z, bias=True),
        },
        "evoformer": init_evoformer_stack(g, cfg.evoformer),
        "single_proj": init_dense(g, d_m, cfg.structure.c_s, bias=True),
        "structure": init_structure_module(g, cfg.structure),
        "msa_head": init_dense(g, d_m, N_MSA_TOK, bias=True),
        "dist_head": init_dense(g, d_z, N_DIST_BINS, bias=True),
    }


def _one_hot(x: torch.Tensor, n: int, dtype) -> torch.Tensor:
    return F.one_hot(x.long(), n).to(dtype)


def embed_inputs(params, batch, cfg: AlphaFoldConfig):
    """batch: msa (B,s,r) int, aatype (B,r) int, residue_index (B,r) int."""
    dt = cfg.compute_dtype
    msa_oh = _one_hot(batch["msa"], N_MSA_TOK, dt)
    aa_oh = _one_hot(batch["aatype"], N_AA, dt)
    msa_rep = dense(params["msa_embed"], msa_oh)
    msa_rep = msa_rep + dense(params["target_embed_m"], aa_oh)[:, None]
    left = dense(params["left_embed"], aa_oh)
    right = dense(params["right_embed"], aa_oh)
    pair = left[:, :, None, :] + right[:, None, :, :]
    ri = batch["residue_index"]
    rel = torch.clamp(ri[:, :, None] - ri[:, None, :], -RELPOS_K,
                      RELPOS_K) + RELPOS_K
    pair = pair + dense(params["relpos_embed"],
                        _one_hot(rel, 2 * RELPOS_K + 1, dt))
    return msa_rep, pair


def embed_recycle(params, msa, pair, prev, cfg: AlphaFoldConfig):
    """Add recycled features: LN'ed previous reps and a binned distance
    embedding of the previous predicted positions."""
    prev_msa_row, prev_pair, prev_pos = prev
    msa = msa.clone()
    msa[:, 0] += layer_norm(params["recycle"]["ln_m"],
                            prev_msa_row).to(msa.dtype)
    pair = pair + layer_norm(params["recycle"]["ln_z"],
                             prev_pair).to(pair.dtype)
    d = torch.linalg.norm(prev_pos[:, :, None] - prev_pos[:, None] + 1e-8,
                          dim=-1)
    edges = torch.linspace(3.375, 21.375, cfg.recycle_bins - 1,
                           dtype=torch.float32, device=d.device)
    bins = torch.sum(d[..., None] > edges, dim=-1)
    pair = pair + dense(params["recycle"]["dist_embed"],
                        _one_hot(bins, cfg.recycle_bins, pair.dtype))
    return msa, pair


def alphafold_iteration(params, batch, prev, cfg: AlphaFoldConfig):
    """One recycling iteration: embed -> Evoformer -> structure + heads."""
    dt = cfg.compute_dtype
    msa, pair = embed_inputs(params, batch, cfg)
    msa, pair = embed_recycle(params, msa, pair, prev, cfg)
    msa = msa.to(dt)
    pair = pair.to(dt)

    seq_mask = batch["seq_mask"]
    pair_mask = seq_mask[:, :, None] * seq_mask[:, None, :]
    msa, pair = evoformer_stack(params["evoformer"], msa, pair,
                                batch["msa_mask"], seq_mask, pair_mask,
                                cfg=cfg.evoformer)

    single = dense(params["single_proj"], msa[:, 0].float())
    coords, frames, traj = structure_module(params["structure"], single,
                                            pair.float(), seq_mask,
                                            cfg.structure)
    return {
        "msa": msa,
        "pair": pair,
        "coords": coords,
        "frames": frames,
        "traj": traj,
        "msa_logits": dense(params["msa_head"], msa.float()),
        "distogram_logits": dense(params["dist_head"], pair.float()),
    }


def alphafold_forward(params, batch, cfg: AlphaFoldConfig, *,
                      n_recycle: int | None = None):
    """Full forward with recycling (``n_recycle`` extra passes, default the
    config's), under ``torch.inference_mode``. ``batch`` is a dict of tensors
    on the parameters' device."""
    if n_recycle is None:
        n_recycle = cfg.n_recycle
    b, s, r = batch["msa"].shape
    dev = batch["msa"].device
    with torch.inference_mode():
        prev = (
            torch.zeros((b, r, cfg.d_msa), dtype=torch.float32, device=dev),
            torch.zeros((b, r, r, cfg.d_pair), dtype=torch.float32, device=dev),
            torch.zeros((b, r, 3), dtype=torch.float32, device=dev),
        )
        for _ in range(n_recycle):
            out = alphafold_iteration(params, batch, prev, cfg)
            prev = (out["msa"][:, 0].float(), out["pair"].float(),
                    out["coords"])
        return alphafold_iteration(params, batch, prev, cfg)
