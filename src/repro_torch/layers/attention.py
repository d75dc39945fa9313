"""Gated attention projections (merged QKV, sigmoid output gate).

The attention itself is ``kernels.ops.fused_attention``; these are the
projections around it, in the reference's layouts: ``project_qkv`` returns
(..., S, H, hd) views into one merged GEMM's output, and ``output_proj``
gates the context through the ``bias_sigmoid_mul`` kernel.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ops
from repro_torch.layers.params import Params, init_dense


class AttnDims(NamedTuple):
    n_heads: int
    n_kv: int
    head_dim: int


def init_attention(generator: torch.Generator, d_model: int, n_heads: int,
                   n_kv: int, head_dim: int, *, qkv_bias: bool = False,
                   out_bias: bool = False, gating: bool = False,
                   d_out: int | None = None, dtype=torch.float32) -> Params:
    """Merged-QKV attention parameters (Merge GEMM, paper §IV.A.1)."""
    d_out = d_out or d_model
    qkv_dim = (n_heads + 2 * n_kv) * head_dim
    p = {
        "wqkv": init_dense(generator, d_model, qkv_dim, bias=qkv_bias,
                           dtype=dtype),
        "wo": init_dense(generator, n_heads * head_dim, d_out, bias=out_bias,
                         zero_init=True, dtype=dtype),
    }
    if gating:
        p["wg"] = init_dense(generator, d_model, n_heads * head_dim, bias=True,
                             dtype=dtype)
        # AlphaFold convention: gate bias init to 1 => gates start open.
        p["wg"]["b"] = torch.ones_like(p["wg"]["b"])
    return p


def project_qkv(p: Params, x: torch.Tensor, dims: AttnDims,
                compute_dtype=torch.bfloat16):
    """x: (..., S, D) -> q (..., S, H, hd), k/v (..., S, KV, hd): strided
    views into the merged projection, which the attention kernel reads in
    place."""
    h, kv, hd = dims
    y = x.to(compute_dtype) @ p["wqkv"]["w"].to(compute_dtype)
    if "b" in p["wqkv"]:
        y = y + p["wqkv"]["b"].to(compute_dtype)
    q, k, v = torch.split(y, [h * hd, kv * hd, kv * hd], dim=-1)
    q = q.unflatten(-1, (h, hd))
    k = k.unflatten(-1, (kv, hd))
    v = v.unflatten(-1, (kv, hd))
    return q, k, v


def output_proj(p: Params, ctx: torch.Tensor,
                x_for_gate: torch.Tensor | None = None) -> torch.Tensor:
    """ctx: (..., S, H, hd) -> (..., S, d_out); optional sigmoid gating."""
    dt = ctx.dtype
    flat = ctx.flatten(-2)
    if "wg" in p and x_for_gate is not None:
        g = x_for_gate.to(dt) @ p["wg"]["w"].to(dt)
        flat = ops.bias_sigmoid_mul(g, p["wg"]["b"], flat)
    out = flat @ p["wo"]["w"].to(dt)
    if "b" in p["wo"]:
        out = out + p["wo"]["b"].to(dt)
    return out
