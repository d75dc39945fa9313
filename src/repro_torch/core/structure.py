"""Structure module: Invariant Point Attention + backbone frame updates.

The port of the reference's reduced AlphaFold structure module: shared-weight
iterations of IPA (scalar, point and pair attention terms), residue frames
updated by quaternion composition. It runs in fp32; its LayerNorms go
through the LayerNorm kernel, the rest is plain torch (the reference has no
TPU kernel here).

Frames are (rotation (..., 3, 3), translation (..., 3)) acting as x -> Rx + t.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.alphafold import StructureConfig
from repro_torch.layers.norms import init_layer_norm, layer_norm
from repro_torch.layers.params import Params, dense, init_dense


# --- rigid-frame utilities --------------------------------------------------

def identity_frames(shape, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    rot = torch.eye(3, dtype=torch.float32, device=device).expand(
        *shape, 3, 3).clone()
    trans = torch.zeros(*shape, 3, dtype=torch.float32, device=device)
    return rot, trans


def frames_apply(rot, trans, x):
    """x: (..., P, 3) points in local coords -> global."""
    return torch.einsum("...ij,...pj->...pi", rot, x) + trans[..., None, :]


def frames_invert_apply(rot, trans, x):
    return torch.einsum("...ji,...pj->...pi", rot, x - trans[..., None, :])


def quat_to_rot(q):
    """Unnormalized quaternion (..., 4) -> rotation matrix (..., 3, 3)."""
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-8)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y**2 + z**2), 2 * (x * y - w * z),
                         2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x**2 + z**2),
                         2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                         1 - 2 * (x**2 + y**2)], -1),
        ],
        dim=-2,
    )


def compose_frames(rot1, trans1, rot2, trans2):
    """(R1,t1) ∘ (R2,t2): first apply 2, then 1."""
    rot = torch.einsum("...ij,...jk->...ik", rot1, rot2)
    trans = torch.einsum("...ij,...j->...i", rot1, trans2) + trans1
    return rot, trans


def frames_from_3_points(x1, x2, x3):
    """Gram-Schmidt frames from 3 points (AlphaFold Alg. 21): origin x2,
    x3 - x2 defines e1. Builds ground-truth frames from CA traces."""
    v1 = x3 - x2
    v2 = x1 - x2
    e1 = v1 / (torch.linalg.norm(v1, dim=-1, keepdim=True) + 1e-8)
    u2 = v2 - e1 * torch.sum(e1 * v2, dim=-1, keepdim=True)
    e2 = u2 / (torch.linalg.norm(u2, dim=-1, keepdim=True) + 1e-8)
    e3 = torch.linalg.cross(e1, e2, dim=-1)
    rot = torch.stack([e1, e2, e3], dim=-1)  # columns are the basis
    return rot, x2


# --- IPA --------------------------------------------------------------------

def init_ipa(generator: torch.Generator, cfg: StructureConfig) -> Params:
    h, c = cfg.n_heads, cfg.c_hidden
    qp, vp = cfg.n_qk_points, cfg.n_v_points
    concat_dim = h * c + h * cfg.c_z + h * vp * 4
    g = generator
    return {
        "q": init_dense(g, cfg.c_s, h * c, bias=False),
        "kv": init_dense(g, cfg.c_s, 2 * h * c, bias=False),
        "q_pts": init_dense(g, cfg.c_s, h * qp * 3, bias=False),
        "kv_pts": init_dense(g, cfg.c_s, h * (qp + vp) * 3, bias=False),
        "bias_z": init_dense(g, cfg.c_z, h, bias=False),
        "head_w": torch.zeros((h,), dtype=torch.float32),
        "out": init_dense(g, concat_dim, cfg.c_s, bias=True, zero_init=True),
    }


def ipa(p: Params, s: torch.Tensor, z: torch.Tensor, rot, trans, seq_mask,
        cfg: StructureConfig) -> torch.Tensor:
    """s: (B, r, c_s); z: (B, r, r, c_z); frames (B, r, 3, 3)/(B, r, 3)."""
    b, r, _ = s.shape
    h, c = cfg.n_heads, cfg.c_hidden
    qp, vp = cfg.n_qk_points, cfg.n_v_points

    q = dense(p["q"], s).reshape(b, r, h, c)
    k, v = torch.chunk(dense(p["kv"], s).reshape(b, r, h, 2 * c), 2, dim=-1)
    q_pts = dense(p["q_pts"], s).reshape(b, r, h * qp, 3)
    kv_pts = dense(p["kv_pts"], s).reshape(b, r, h * (qp + vp), 3)
    q_pts = frames_apply(rot, trans, q_pts).reshape(b, r, h, qp, 3)
    kv_pts = frames_apply(rot, trans, kv_pts)
    k_pts, v_pts = torch.split(kv_pts.reshape(b, r, h, qp + vp, 3), [qp, vp],
                               dim=-2)

    logits = torch.einsum("bihc,bjhc->bhij", q, k) * (1.0 / math.sqrt(3 * c))
    logits = logits + torch.einsum("bijh->bhij", dense(p["bias_z"], z)) * (
        1.0 / math.sqrt(3.0))
    d2 = torch.sum(torch.square(q_pts[:, :, None] - k_pts[:, None]), dim=-1)
    gamma = F.softplus(p["head_w"])
    w_pt = gamma * (1.0 / math.sqrt(3.0)) * (9.0 / (2 * qp)) ** 0.5 * 0.5
    logits = logits - torch.einsum("bijhp,h->bhij", d2, w_pt)
    logits = torch.where(seq_mask[:, None, None, :] > 0, logits,
                         torch.full_like(logits, -1e9))
    attn = torch.softmax(logits, dim=-1)

    o_scalar = torch.einsum("bhij,bjhc->bihc", attn, v).reshape(b, r, h * c)
    o_pair = torch.einsum("bhij,bijc->bihc", attn, z).reshape(b, r, h * cfg.c_z)
    o_pts = torch.einsum("bhij,bjhpx->bihpx", attn, v_pts)
    o_pts_local = frames_invert_apply(rot, trans,
                                      o_pts.reshape(b, r, h * vp, 3))
    o_pts_norm = torch.linalg.norm(o_pts_local + 1e-8, dim=-1, keepdim=True)
    o_pts_feat = torch.cat([o_pts_local, o_pts_norm], dim=-1).reshape(
        b, r, h * vp * 4)

    o = torch.cat([o_scalar, o_pair, o_pts_feat], dim=-1)
    return dense(p["out"], o)


# --- structure module -------------------------------------------------------

def init_structure_module(generator: torch.Generator,
                          cfg: StructureConfig) -> Params:
    g = generator
    return {
        "ln_s": init_layer_norm(cfg.c_s),
        "ln_z": init_layer_norm(cfg.c_z),
        "proj_s": init_dense(g, cfg.c_s, cfg.c_s, bias=False),
        "ipa": init_ipa(g, cfg),
        "ln_ipa": init_layer_norm(cfg.c_s),
        "trans1": init_dense(g, cfg.c_s, cfg.c_s, bias=True),
        "trans2": init_dense(g, cfg.c_s, cfg.c_s, bias=True),
        "trans3": init_dense(g, cfg.c_s, cfg.c_s, bias=True, zero_init=True),
        "ln_trans": init_layer_norm(cfg.c_s),
        "bb_update": init_dense(g, cfg.c_s, 6, bias=True, zero_init=True),
    }


def structure_module(p: Params, s_init: torch.Tensor, z: torch.Tensor,
                     seq_mask: torch.Tensor, cfg: StructureConfig):
    """Returns (final CA coords (B, r, 3), final frames, per-iteration
    frames stacked on a leading axis)."""
    b, r, _ = s_init.shape
    s = dense(p["proj_s"], layer_norm(p["ln_s"], s_init))
    z_n = layer_norm(p["ln_z"], z)
    rot, trans = identity_frames((b, r), device=s.device)
    traj_rot, traj_trans = [], []
    for _ in range(cfg.n_iterations):
        s = s + ipa(p["ipa"], s, z_n, rot, trans, seq_mask, cfg)
        s = layer_norm(p["ln_ipa"], s)
        h = torch.relu(dense(p["trans1"], s))
        h = torch.relu(dense(p["trans2"], h))
        s = layer_norm(p["ln_trans"], s + dense(p["trans3"], h))
        upd = dense(p["bb_update"], s)  # (b, r, 6)
        quat = torch.cat([torch.ones((b, r, 1), dtype=upd.dtype,
                                     device=upd.device), upd[..., :3]], dim=-1)
        rot_u = quat_to_rot(quat)
        trans_u = upd[..., 3:] * cfg.trans_scale
        rot, trans = compose_frames(rot, trans, rot_u, trans_u)
        traj_rot.append(rot)
        traj_trans.append(trans)
    traj = (torch.stack(traj_rot), torch.stack(traj_trans))
    return trans, (rot, trans), traj  # CA coords = frame origins
