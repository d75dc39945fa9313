"""Parameter initialization and application helpers.

Parameters are nested dicts of tensors, as in the reference (the
Evoformer's blocks a list of dicts); ``tree_map`` and ``tree_leaves`` walk
them. ``dense``
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


def init_embedding(generator: torch.Generator, vocab: int, d: int,
                   dtype=torch.float32) -> Params:
    """A (vocab, d) table of N(0, 0.02²) draws."""
    return {"table": torch.randn((vocab, d), generator=generator,
                                 dtype=dtype) * 0.02}


def embed(p: Params, ids: torch.Tensor,
          compute_dtype=torch.bfloat16) -> torch.Tensor:
    """The rows of the table (cast to ``compute_dtype``) at ``ids``."""
    return p["table"].to(compute_dtype)[ids]


def count_params(params) -> int:
    return sum(x.numel() for x in tree_leaves(params))


def cast_tree(params, dtype):
    """Every floating leaf cast to ``dtype``; other leaves as they are."""
    return tree_map(
        lambda x: x.to(dtype) if x.is_floating_point() else x, params)


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leafwise over trees of one structure (dicts and lists
    of tensors)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, t, *(r[i] for r in rest))
                for i, t in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in a fixed order (dict insertion order, list order)."""
    if isinstance(tree, dict):
        return [x for k in tree for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]
