"""AlphaFold model configs (paper Table I) and their dataclasses.

Own copies of the reference's ``EvoformerConfig`` / ``StructureConfig`` /
``AlphaFoldConfig`` with the fields inference reads; ``compute_dtype`` is a
torch dtype. The chunking knobs of the reference (AutoChunk) are not part of
this port yet: they change memory, not numbers.
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
    n_blocks: int = 48


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
