"""Normalization layers backed by the LayerNorm kernel."""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.layers.params import Params


def init_layer_norm(d: int, dtype=torch.float32) -> Params:
    return {"gamma": torch.ones((d,), dtype=dtype),
            "beta": torch.zeros((d,), dtype=dtype)}


def layer_norm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return ops.layer_norm(x, p["gamma"], p["beta"], eps)
