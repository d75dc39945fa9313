"""Normalization layers: LayerNorm backed by the LayerNorm kernel (K1 on
the card), and RMSNorm in plain PyTorch (the reference's is plain JAX)."""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.layers.params import Params


def init_layer_norm(d: int, dtype=torch.float32) -> Params:
    return {"gamma": torch.ones((d,), dtype=dtype),
            "beta": torch.zeros((d,), dtype=dtype)}


def layer_norm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return ops.layer_norm(x, p["gamma"], p["beta"], eps)


def init_rms_norm(d: int, dtype=torch.float32) -> Params:
    return {"gamma": torch.ones((d,), dtype=dtype)}


def rms_norm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """fp32 inside, cast back to ``x``'s dtype."""
    xf = x.float()
    inv = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * inv * p["gamma"].float()).to(x.dtype)
