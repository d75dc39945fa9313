"""Evoformer Transition: LN -> Linear(4x) -> ReLU -> Linear (the LN lives in
the caller)."""
from __future__ import annotations

import torch

from repro_torch.layers.params import Params, dense, init_dense


def init_transition(generator: torch.Generator, d: int, factor: int = 4,
                    dtype=torch.float32) -> Params:
    return {
        "wi": init_dense(generator, d, factor * d, bias=True, dtype=dtype),
        "wo": init_dense(generator, factor * d, d, bias=True, zero_init=True,
                         dtype=dtype),
    }


def transition(p: Params, x: torch.Tensor) -> torch.Tensor:
    return dense(p["wo"], torch.relu(dense(p["wi"], x)))
