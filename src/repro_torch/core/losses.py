"""AlphaFold training losses: masked-MSA, distogram, CA-only FAPE with the
auxiliary trajectory FAPE. The port of the reference's ``core/losses.py``,
in fp32."""
from __future__ import annotations

import torch

from repro_torch.core.structure import frames_from_3_points

N_DIST_BINS = 64


def masked_msa_loss(logits, true_msa, bert_mask):
    """logits (B, s, r, 23); true_msa int (B, s, r); bert_mask (B, s, r)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, true_msa.long()[..., None])[..., 0]
    denom = bert_mask.sum() + 1e-6
    return -(ll * bert_mask).sum() / denom


def distogram_loss(logits, pseudo_beta, seq_mask, min_d=2.3125,
                   max_d=21.6875):
    """logits (B, r, r, 64); pseudo_beta (B, r, 3)."""
    d = torch.linalg.norm(pseudo_beta[:, :, None] - pseudo_beta[:, None]
                          + 1e-8, dim=-1)
    edges = torch.linspace(min_d, max_d, N_DIST_BINS - 1,
                           dtype=torch.float32, device=d.device)
    target = torch.sum(d[..., None] > edges, dim=-1)    # (B, r, r) in [0, 63]
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, target[..., None])[..., 0]
    mask2 = seq_mask[:, :, None] * seq_mask[:, None, :]
    return -(ll * mask2).sum() / (mask2.sum() + 1e-6)


def true_frames_from_ca(coords):
    """Ground-truth frames from a CA trace via Gram-Schmidt on neighbours."""
    prev_ca = torch.roll(coords, 1, dims=-2)
    next_ca = torch.roll(coords, -1, dims=-2)
    return frames_from_3_points(prev_ca, coords, next_ca)


def _pairwise_local(rot, trans, pos):
    """x_ij = R_i^{-1} (pos_j - t_i): (B, i, j, 3)."""
    rel = pos[:, None, :, :] - trans[:, :, None, :]
    return torch.einsum("bixy,bijx->bijy", rot, rel)


def fape(pred_rot, pred_trans, true_rot, true_trans, pred_pos, true_pos,
         seq_mask, clamp=10.0, scale=10.0):
    """Frame-Aligned Point Error (AlphaFold Alg. 28), CA-only variant.
    Frames (B, r, 3, 3), (B, r, 3); positions (B, r, 3)."""
    p_local = _pairwise_local(pred_rot, pred_trans, pred_pos)
    t_local = _pairwise_local(true_rot, true_trans, true_pos)
    err = torch.sqrt(torch.sum(torch.square(p_local - t_local), dim=-1) + 1e-8)
    err = torch.clamp(err, max=clamp) / scale
    mask2 = seq_mask[:, :, None] * seq_mask[:, None, :]
    return (err * mask2).sum() / (mask2.sum() + 1e-6)


def alphafold_loss(outputs, batch, *, w_fape=0.5, w_msa=2.0, w_dist=0.3,
                   w_aux=0.5):
    """outputs: dict from the model; batch: the training features as
    tensors. Returns (total, metrics) with the reference's metric keys."""
    seq_mask = batch["seq_mask"]
    true_pos = batch["pseudo_beta"]
    true_rot, true_trans = true_frames_from_ca(true_pos)
    rot, trans = outputs["frames"]
    l_fape = fape(rot, trans, true_rot, true_trans, trans, true_pos, seq_mask)
    # Aux: mean FAPE over the structure-module trajectory.
    traj_rot, traj_trans = outputs["traj"]
    l_aux = torch.stack([
        fape(r, t, true_rot, true_trans, t, true_pos, seq_mask)
        for r, t in zip(traj_rot, traj_trans)]).mean()
    l_msa = masked_msa_loss(outputs["msa_logits"], batch["true_msa"],
                            batch["bert_mask"])
    l_dist = distogram_loss(outputs["distogram_logits"], true_pos, seq_mask)
    total = w_fape * l_fape + w_aux * l_aux + w_msa * l_msa + w_dist * l_dist
    return total, {"loss": total, "fape": l_fape, "aux_fape": l_aux,
                   "masked_msa": l_msa, "distogram": l_dist}
