"""Plain PyTorch versions of the hand-written kernels.

Each is the same function as its CUDA kernel, written with whole-tensor torch
ops. The wrappers in ``ops`` take them for CPU tensors; ``chip_smoke.py``
holds each kernel against them on the card. They work on any device.
"""
from __future__ import annotations

import torch


def layer_norm_ref(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis with affine, fp32 statistics."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * gamma.float() + beta.float()
    return y.to(x.dtype)


def bias_sigmoid_mul_ref(g: torch.Tensor, bg: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
    """sigmoid(g + bg) * v in fp32, output in v's dtype."""
    gf = g.float() + bg.float()
    return (torch.sigmoid(gf) * v.float()).to(v.dtype)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: torch.Tensor | None = None,
                  mask: torch.Tensor | None = None,
                  scale: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Scores-materialized attention.

    q: (N, Sq, H, D); k, v: (N, Skv, H, D)
    bias: (B, H, Sq, Skv), N % B == 0 (each bias batch element shared by N/B
          consecutive rows), or (H, Sq, Skv) as B=1.
    mask: (N, Skv) additive fp32, broadcast over H and Sq.

    Returns (out (N, Sq, H, D) in q.dtype, lse (N, H, Sq) fp32). The probs
    are cast to v's dtype before the PV product, which accumulates in fp32.
    """
    n = q.shape[0]
    s = torch.einsum("nqhd,nkhd->nhqk", q.float(), k.float()) * scale
    if bias is not None:
        if bias.ndim == 3:
            bias = bias[None]
        b = bias.shape[0]
        s = s.reshape((b, n // b) + s.shape[1:])
        s = s + bias.float()[:, None]
        s = s.reshape((n,) + s.shape[2:])
    if mask is not None:
        s = s + mask.float()[:, None, None, :]
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    ex = torch.exp(s - m)
    l = ex.sum(dim=-1, keepdim=True)
    probs = (ex / l.clamp_min(1e-30)).to(v.dtype)
    out = torch.einsum("nhqk,nkhd->nqhd", probs.float(), v.float()).to(q.dtype)
    lse = (m + torch.log(l.clamp_min(1e-30)))[..., 0]
    return out, lse
