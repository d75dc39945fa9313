"""AlphaFold model configs (paper Table I) and their dataclasses.

Own copies of the reference's ``EvoformerConfig`` / ``StructureConfig`` /
``AlphaFoldConfig`` with the fields inference and training read;
``compute_dtype`` is a torch dtype and lives on ``AlphaFoldConfig`` only.
``EvoformerConfig`` carries the reference's chunk and tile knobs and its
``auto_chunk`` switch: knobs left at 0 are filled per forward by the
AutoChunk planner (``repro_torch.memory.autochunk``) from the device's
memory budget, and a knob set by hand is kept. They change memory and time,
never the numbers. What each knob bounds on each branch of the port is
said beside it below.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch


@dataclass(frozen=True)
class EvoformerConfig:
    d_msa: int = 256
    d_pair: int = 128
    msa_heads: int = 8
    pair_heads: int = 4
    head_dim: int = 32
    opm_dim: int = 32
    tri_mult_dim: int = 128
    transition_factor: int = 4
    dropout_msa: float = 0.15
    dropout_pair: float = 0.25
    n_blocks: int = 48
    # What a checkpointed block keeps for its backward (the reference's
    # remat policy): "nothing" keeps only its inputs and recomputes all
    # (least memory), "dots" also keeps the outputs of its matrix products
    # (less recompute, more activation memory). Read by
    # ``core.evoformer.evoformer_stack`` when it checkpoints each block.
    remat_policy: str = "nothing"
    # OPM j-chunking of the materialized branch: the (B, r, r, c, c) outer
    # product is formed in j blocks of this size (0 = the whole row; a
    # block that does not divide r runs the whole row, as in the reference).
    opm_chunk: int = 0
    # Paper §V.C group chunking at the four attention sites (MSA row, MSA
    # column, triangle start and end): the G groups run in sequential
    # chunks of this size on either branch (0 = off; a chunk that does not
    # divide G runs whole, as in the reference).
    inference_chunk: int = 0
    # The fused attention op's KV tile (0 = default). The flash kernel (K5)
    # keeps no (G, H, S, tile) block and its KV tile is fixed by its
    # tensor-core design, so on the card it has no effect; the plain version
    # takes this many query rows at a time, bounding its scores at
    # (N, H, tile, Skv).
    attn_kv_tile: int = 0
    # The fused triangle op's tile (0 = default). K7 stages the whole gated
    # a and b in its workspace and its k tile is fixed by its fragment
    # layout, so on the card it has no effect; the plain version and the
    # recompute backward take j blocks of this size (default 128).
    tri_k_tile: int = 0
    # The fused outer-product-mean op's tile (0 = default). K8 writes only
    # its output and keeps its s ring on chip, so on the card it has no
    # effect; the plain version and the recompute backward take j blocks of
    # this size (default 128).
    opm_s_tile: int = 0
    # Let the AutoChunk planner fill every knob above left at 0 from the
    # memory budget, once per forward (``core.alphafold.alphafold_forward``).
    auto_chunk: bool = True


@dataclass(frozen=True)
class StructureConfig:
    c_s: int = 384          # single representation
    c_z: int = 128          # pair representation
    n_heads: int = 12
    c_hidden: int = 16      # scalar head dim
    n_qk_points: int = 4
    n_v_points: int = 8
    n_iterations: int = 8
    trans_scale: float = 10.0


@dataclass(frozen=True)
class AlphaFoldConfig:
    evoformer: EvoformerConfig = field(default_factory=EvoformerConfig)
    structure: StructureConfig = field(default_factory=StructureConfig)
    n_recycle: int = 3          # extra passes (total passes = n_recycle + 1)
    recycle_bins: int = 15
    compute_dtype: torch.dtype = torch.bfloat16

    @property
    def d_msa(self):
        return self.evoformer.d_msa

    @property
    def d_pair(self):
        return self.evoformer.d_pair


# Full AlphaFold-2 model: 48 Evoformer blocks, Hm=256, Hz=128 (~93M params).
FULL = AlphaFoldConfig(
    evoformer=EvoformerConfig(d_msa=256, d_pair=128, msa_heads=8, pair_heads=4,
                              head_dim=32, opm_dim=32, tri_mult_dim=128,
                              n_blocks=48),
    structure=StructureConfig(c_s=384, c_z=128, n_heads=12, c_hidden=16,
                              n_qk_points=4, n_v_points=8, n_iterations=8),
    n_recycle=3,
)

# Paper Table I shapes.
INITIAL_TRAINING = {"n_res": 256, "n_seq": 128, "batch": 128}
FINE_TUNING = {"n_res": 384, "n_seq": 512, "batch": 128}

MINI = AlphaFoldConfig(
    evoformer=EvoformerConfig(d_msa=64, d_pair=32, msa_heads=4, pair_heads=2,
                              head_dim=16, opm_dim=16, tri_mult_dim=32,
                              n_blocks=4),
    structure=StructureConfig(c_s=64, c_z=32, n_heads=4, c_hidden=8,
                              n_qk_points=4, n_v_points=4, n_iterations=4),
    n_recycle=1,
)

SMOKE = AlphaFoldConfig(
    evoformer=EvoformerConfig(d_msa=32, d_pair=16, msa_heads=4, pair_heads=2,
                              head_dim=8, opm_dim=8, tri_mult_dim=16,
                              n_blocks=2),
    structure=StructureConfig(c_s=32, c_z=16, n_heads=4, c_hidden=8,
                              n_qk_points=2, n_v_points=2, n_iterations=2),
    n_recycle=1,
)
