"""Parameter initialization and application helpers.

Parameters are nested dicts of tensors, as in the reference. ``dense``
weights keep the reference's ``(d_in, d_out)`` layout, so a weight crosses
between the two packages unchanged. Initializers draw from an explicit CPU
``torch.Generator``; the caller moves the finished tree to its device.
"""
from __future__ import annotations

import math

import torch

Params = dict


def trunc_normal(generator: torch.Generator, shape, scale: float,
                 dtype=torch.float32) -> torch.Tensor:
    """Truncated-normal (±2σ) fan-in init: the standard normal truncated to
    [-2, 2], times ``scale / sqrt(fan_in)``."""
    std = scale / max(1.0, math.sqrt(shape[0] if len(shape) >= 2 else 1))
    t = torch.empty(shape, dtype=dtype)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t * std


def init_dense(generator: torch.Generator, d_in: int, d_out: int, *,
               bias: bool = True, scale: float = 1.0, zero_init: bool = False,
               dtype=torch.float32) -> Params:
    p = {}
    if zero_init:
        p["w"] = torch.zeros((d_in, d_out), dtype=dtype)
    else:
        p["w"] = trunc_normal(generator, (d_in, d_out), scale, dtype)
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype)
    return p


def dense(p: Params, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    dt = compute_dtype or x.dtype
    y = x.to(dt) @ p["w"].to(dt)
    if "b" in p:
        y = y + p["b"].to(dt)
    return y
