"""Synthetic AlphaFold features, deterministic from a seed.

The port's own numpy copy of the reference generator (``protein_batches``):
for a seed it yields byte-identical arrays. ``n_real`` pads a shorter
protein: residues from ``n_real`` on are padding, with ``seq_mask`` and
``msa_mask`` zeroed there.
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Iterator

import numpy as np

N_AA = 21          # 20 amino acids + gap/unknown
N_MSA_TOK = 23     # AlphaFold MSA alphabet (aa + gap + mask)


@dataclass(frozen=True)
class ProteinBatch:
    """AlphaFold featurization contract (the subset the model consumes)."""
    msa: np.ndarray           # (B, N_s, N_r) int32 in [0, N_MSA_TOK)
    msa_mask: np.ndarray      # (B, N_s, N_r) float32
    residue_index: np.ndarray # (B, N_r) int32
    aatype: np.ndarray        # (B, N_r) int32 in [0, N_AA)
    seq_mask: np.ndarray      # (B, N_r) float32
    pseudo_beta: np.ndarray   # (B, N_r, 3) float32 ground-truth CB coords
    bert_mask: np.ndarray     # (B, N_s, N_r) float32
    true_msa: np.ndarray      # (B, N_s, N_r) int32 unmasked MSA

    def as_dict(self) -> dict[str, np.ndarray]:
        return {f.name: getattr(self, f.name) for f in fields(self)}


def protein_batches(
    *, batch: int, n_seq: int, n_res: int, seed: int = 0,
    mask_rate: float = 0.15, n_real: int | None = None,
) -> Iterator[ProteinBatch]:
    """Synthetic homologous-family generator: a ground-truth backbone drawn
    as a random walk; MSA rows are the target sequence with
    position-dependent mutation rates. ``n_real`` (default ``n_res``) is the
    protein's true length; the rest of the ``n_res`` positions are masked."""
    if n_real is not None and not 0 < n_real <= n_res:
        raise ValueError(f"n_real={n_real} must lie in [1, n_res={n_res}]")
    rng = np.random.default_rng(seed)
    while True:
        aatype = rng.integers(0, 20, size=(batch, n_res)).astype(np.int32)
        steps = rng.normal(size=(batch, n_res, 3))
        steps /= np.linalg.norm(steps, axis=-1, keepdims=True) + 1e-8
        coords = np.cumsum(3.8 * steps, axis=1).astype(np.float32)
        conservation = rng.beta(2.0, 2.0, size=(batch, 1, n_res))
        mutate = rng.random((batch, n_seq, n_res)) > conservation
        subs = rng.integers(0, 20, size=(batch, n_seq, n_res))
        msa = np.where(mutate, subs, aatype[:, None, :]).astype(np.int32)
        msa[:, 0] = aatype  # row 0 is the target sequence
        bert_mask = (rng.random((batch, n_seq, n_res)) < mask_rate).astype(np.float32)
        masked_msa = np.where(bert_mask > 0, N_MSA_TOK - 1, msa).astype(np.int32)
        msa_mask = np.ones((batch, n_seq, n_res), np.float32)
        seq_mask = np.ones((batch, n_res), np.float32)
        if n_real is not None:
            msa_mask[..., n_real:] = 0.0
            seq_mask[..., n_real:] = 0.0
        yield ProteinBatch(
            msa=masked_msa,
            msa_mask=msa_mask,
            residue_index=np.tile(np.arange(n_res, dtype=np.int32), (batch, 1)),
            aatype=aatype,
            seq_mask=seq_mask,
            pseudo_beta=coords,
            bert_mask=bert_mask,
            true_msa=msa,
        )
