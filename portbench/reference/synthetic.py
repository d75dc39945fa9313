"""AlphaFold features from a seed: a frozen copy of the port's synthetic
protein generator (``repro_torch.data.synthetic.protein_batches``), so the
benchmark's inputs do not move when the program's generator does.

A ground-truth backbone is a random walk of 3.8 Å steps; MSA rows are the
target sequence with position-dependent mutations; 15% of MSA entries are
masked for the BERT-style loss. ``n_real`` < ``n_res`` pads the protein:
positions from ``n_real`` on are padding, with ``seq_mask``, ``msa_mask``
and ``bert_mask`` zero there.
"""
from __future__ import annotations

import numpy as np

N_MSA_TOK = 23


def protein_batch(*, rng: np.random.Generator, batch: int, n_seq: int,
                  n_res: int, n_real: int | None = None,
                  mask_rate: float = 0.15) -> dict[str, np.ndarray]:
    """One batch of features drawn from ``rng``."""
    if n_real is not None and not 0 < n_real <= n_res:
        raise ValueError(f"n_real={n_real} must lie in [1, n_res={n_res}]")
    aatype = rng.integers(0, 20, size=(batch, n_res)).astype(np.int32)
    steps = rng.normal(size=(batch, n_res, 3))
    steps /= np.linalg.norm(steps, axis=-1, keepdims=True) + 1e-8
    coords = np.cumsum(3.8 * steps, axis=1).astype(np.float32)
    conservation = rng.beta(2.0, 2.0, size=(batch, 1, n_res))
    mutate = rng.random((batch, n_seq, n_res)) > conservation
    subs = rng.integers(0, 20, size=(batch, n_seq, n_res))
    msa = np.where(mutate, subs, aatype[:, None, :]).astype(np.int32)
    msa[:, 0] = aatype
    bert_mask = (rng.random((batch, n_seq, n_res)) < mask_rate).astype(
        np.float32)
    masked_msa = np.where(bert_mask > 0, N_MSA_TOK - 1, msa).astype(np.int32)
    msa_mask = np.ones((batch, n_seq, n_res), np.float32)
    seq_mask = np.ones((batch, n_res), np.float32)
    if n_real is not None:
        msa_mask[..., n_real:] = 0.0
        seq_mask[..., n_real:] = 0.0
        bert_mask[..., n_real:] = 0.0
    return {"msa": masked_msa, "msa_mask": msa_mask,
            "residue_index": np.tile(np.arange(n_res, dtype=np.int32),
                                     (batch, 1)),
            "aatype": aatype, "seq_mask": seq_mask, "pseudo_beta": coords,
            "bert_mask": bert_mask, "true_msa": msa}
