"""Attention: merged-QKV projections, the Evoformer's gated attention, and
the decoder LMs' attention.

The Evoformer's attention is ``kernels.ops.fused_attention`` (the scores
never in memory) or ``evoformer_attention`` (the scores materialized, then
the fused softmax); ``project_qkv`` returns (..., S, H, hd) views into one
merged GEMM's output (RMS-normed q and k where the parameters carry
``q_norm``/``k_norm``), and ``output_proj`` gates the context through the
``bias_sigmoid_mul`` kernel.

The decoder LMs' attention is plain PyTorch, as the reference's is plain
JAX (no Pallas kernel serves it), written as the reference's loops so that
its block knobs mean what the serving planner thinks they mean:

* ``blockwise_attention`` — an online softmax over ``kv_block`` chunks of
  the keys, fp32 running max and sum (training forward and prefill);
* ``sliding_window_attention`` — each ``q_block`` of queries against the
  ``window + q_block`` keys it can see;
* ``decode_attention`` — one new token against a KV cache, masked by length
  (and window).

Each takes GQA's KV heads and repeats them to the query heads. Only the
forward is ported; the reference's ``custom_vjp`` backwards wait for
decoder training. Products run in the inputs' dtype, their outputs cast to
fp32 where the reference casts them, and probabilities are rounded to the
values' dtype before the second product, as in the reference.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ops
from repro_torch.layers.norms import init_rms_norm, rms_norm
from repro_torch.layers.params import Params, init_dense

NEG_INF = -1e9


class AttnDims(NamedTuple):
    n_heads: int
    n_kv: int
    head_dim: int


def init_attention(generator: torch.Generator, d_model: int, n_heads: int,
                   n_kv: int, head_dim: int, *, qkv_bias: bool = False,
                   out_bias: bool = False, gating: bool = False,
                   qk_norm: bool = False, d_out: int | None = None,
                   dtype=torch.float32) -> Params:
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
    if qk_norm:
        p["q_norm"] = init_rms_norm(head_dim, dtype)
        p["k_norm"] = init_rms_norm(head_dim, dtype)
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
    if "q_norm" in p:
        q = rms_norm(p["q_norm"], q)
        k = rms_norm(p["k_norm"], k)
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


def evoformer_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        bias: torch.Tensor | None = None,
                        mask: torch.Tensor | None = None) -> torch.Tensor:
    """Scores-materialized gated attention, the reference's A/B form of
    ``ops.fused_attention`` with the same contract: q, k, v (N, S, H, hd);
    bias (B, H, Sq, Skv) with N % B == 0 (each bias batch element shared by
    N/B rows); mask (N, Skv) additive. The (N, H, Sq, Skv) scores are one
    product, their softmax is ``ops.fused_softmax`` (the fused softmax
    kernel on the card), and the context a second product. Returns
    (N, Sq, H, hd)."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    scores = torch.einsum("nqhd,nkhd->nhqk", q, k)
    probs = ops.fused_softmax(scores, bias=bias, mask=mask, scale=scale)
    return torch.einsum("nhqk,nkhd->nqhd", probs, v)


def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(..., S, KV, hd) -> (..., S, H, hd), each KV head repeated for its
    group of query heads."""
    kv = k.shape[-2]
    if kv == n_heads:
        return k
    return k.repeat_interleave(n_heads // kv, dim=-2)


def _scores(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """(B, Sq, H, hd) x (B, Sk, H, hd) -> fp32 (B, H, Sq, Sk) logits: the
    product in the inputs' common dtype (its output rounded to it), then
    cast and scaled, as the reference's ``einsum(...).astype(float32)``."""
    dt = torch.promote_types(q.dtype, k.dtype)
    return torch.einsum("bqhd,bkhd->bhqk", q.to(dt), k.to(dt)).float() * scale


# ---------------------------------------------------------------------------
# Decoder LMs
# ---------------------------------------------------------------------------

def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, q_offset: int = 0,
                        q_block: int = 512,
                        kv_block: int = 1024) -> torch.Tensor:
    """Online-softmax attention. q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd).

    ``q_offset``: the position of q[0] relative to k[0]. The query axis is
    processed whole (``q_block`` is taken and ignored, as in the
    reference); the keys in ``kv_block`` chunks, ``min(kv_block, Skv)``
    of which must divide Skv (the reference asserts it: ROADMAP.md R6)."""
    h = q.shape[2]
    k = _expand_kv(k, h)
    v = _expand_kv(v, h)
    b, sq, _, hd = q.shape
    skv = k.shape[1]
    kv_block = min(kv_block, skv)
    if skv % kv_block:
        raise ValueError(f"blockwise_attention: kv_block={kv_block} does not "
                         f"divide the {skv} keys")
    scale = 1.0 / (hd ** 0.5)
    m = torch.full((b, h, sq), float("-inf"), device=q.device)
    l = torch.zeros((b, h, sq), device=q.device)
    acc = torch.zeros((b, h, sq, v.shape[-1]), device=q.device)
    qpos = q_offset + torch.arange(sq, device=q.device)
    for j in range(skv // kv_block):
        k_j = k[:, j * kv_block:(j + 1) * kv_block]
        v_j = v[:, j * kv_block:(j + 1) * kv_block]
        s = _scores(q, k_j, scale)
        if causal:
            kpos = j * kv_block + torch.arange(kv_block, device=q.device)
            s = s.masked_fill(qpos[:, None] < kpos[None, :], NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(v_j.dtype), v_j).float()
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)          # (B, Sq, H, hd_v)


def sliding_window_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, window: int,
                             q_offset: int = 0,
                             q_block: int = 512) -> torch.Tensor:
    """Causal attention in which each token sees itself and ``window``
    predecessors. q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd). Query block i
    reads only keys [i·qb + q_offset − window, i·qb + q_offset + qb) of the
    keys padded on the left by ``window`` rows; ``min(q_block, Sq)`` must
    divide Sq (the reference asserts it)."""
    b, sq, h, hd = q.shape
    k = _expand_kv(k, h)
    v = _expand_kv(v, h)
    q_block = min(q_block, sq)
    if sq % q_block:
        raise ValueError(f"sliding_window_attention: q_block={q_block} does "
                         f"not divide the {sq} queries")
    kp = torch.nn.functional.pad(k, (0, 0, 0, 0, window, 0))
    vp = torch.nn.functional.pad(v, (0, 0, 0, 0, window, 0))
    span = window + q_block
    scale = 1.0 / (hd ** 0.5)
    outs = []
    for i in range(sq // q_block):
        start = q_offset + i * q_block
        q_i = q[:, i * q_block:(i + 1) * q_block]
        k_i, v_i = kp[:, start:start + span], vp[:, start:start + span]
        qpos = start + torch.arange(q_block, device=q.device)
        kpos = start - window + torch.arange(span, device=q.device)
        visible = ((kpos[None, :] <= qpos[:, None])
                   & (kpos[None, :] > qpos[:, None] - window - 1)
                   & (kpos[None, :] >= 0))
        s = _scores(q_i, k_i, scale).masked_fill(~visible, NEG_INF)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        out = torch.einsum("bhqk,bkhd->bhqd", p.to(v_i.dtype), v_i)
        out = out / p.sum(dim=-1)[..., None].to(out.dtype)
        outs.append(out.to(q.dtype))
    return torch.cat(outs, dim=2).transpose(1, 2)     # (B, Sq, H, hd)


def masked_decode_softmax_av(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor,
                             valid: torch.Tensor) -> torch.Tensor:
    """One query token against cached keys: q (B, 1, H, hd), k and v
    (B, S, H, hd), ``valid`` (B, S) the cache rows it may see. fp32
    softmax; returns (B, 1, H, hd) in q's dtype."""
    logits = _scores(q, k, 1.0 / (q.shape[-1] ** 0.5))
    logits = logits.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    out = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype), v)
    out = out / p.sum(dim=-1)[..., None].to(out.dtype)
    return out.transpose(1, 2).to(q.dtype)


def scatter_rows(cache: torch.Tensor, new: torch.Tensor,
                 rows: torch.Tensor) -> torch.Tensor:
    """A copy of the cache ``cache`` (B, S, ...) with row ``rows[b]`` of
    batch b set to ``new[b, 0]``: the reference's one-row
    ``dynamic_update_slice`` of a decode write, by index assignment, which
    raises on a row past the end where the reference would clamp it."""
    out = cache.clone()
    out[torch.arange(cache.shape[0], device=cache.device), rows] = \
        new[:, 0].to(cache.dtype)
    return out


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                     window: int | None = None) -> torch.Tensor:
    """q: (B, 1, H, hd); caches (B, S, KV, hd); cache_len (B,) the valid
    rows of each cache (and, with ``window``, only its last ``window``)."""
    h = q.shape[2]
    pos = torch.arange(k_cache.shape[1], device=q.device)
    valid = pos[None, :] < cache_len[:, None]
    if window is not None:
        valid &= pos[None, :] >= (cache_len[:, None] - window)
    return masked_decode_softmax_av(q, _expand_kv(k_cache, h),
                                    _expand_kv(v_cache, h), valid)
