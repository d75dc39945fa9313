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
  the keys, fp32 running max and sum (training and prefill);
* ``sliding_window_attention`` — each ``q_block`` of queries against the
  ``window + q_block`` keys it can see;
* ``decode_attention`` — one new token against a KV cache, masked by length
  (and window).

Each takes GQA's KV heads and repeats them to the query heads. The first
two are ``torch.autograd.Function``s, the reference's ``custom_vjp``s:
the forward saves only (q, k, v, out, lse) and the backward recomputes
the probabilities block by block, so training keeps no
(B, H, Sq, kv_block) tensor per block. Products run in the inputs' dtype,
their outputs cast to fp32 where the reference casts them, and
probabilities are rounded to the values' dtype before the second product,
as in the reference; the backward runs in fp32.
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

def _kv_block_of(skv: int, kv_block: int) -> int:
    """``min(kv_block, Skv)``, which must divide Skv (ROADMAP.md R6)."""
    kv_block = min(kv_block, skv)
    if skv % kv_block:
        raise ValueError(f"blockwise_attention: kv_block={kv_block} does not "
                         f"divide the {skv} keys")
    return kv_block


def _causal_fill(s, q_offset: int, j0: int):
    """Scores (B, H, Sq, kvb) of keys from ``j0`` on, NEG_INF where a key
    lies after its query."""
    qpos = q_offset + torch.arange(s.shape[2], device=s.device)
    kpos = j0 + torch.arange(s.shape[3], device=s.device)
    return s.masked_fill(qpos[:, None] < kpos[None, :], NEG_INF)


def _flash_fwd_core(q, k, v, *, causal: bool, q_offset: int, kv_block: int):
    """q (B, Sq, H, hd); k, v (B, Skv, H, hd), the heads already expanded.
    Returns out (B, Sq, H, hd_v) in q's dtype and the fp32 lse (B, H, Sq),
    ``m + log(max(l, 1e-30))``, as the reference's ``_flash_fwd_core``."""
    b, sq, h, hd = q.shape
    skv = k.shape[1]
    kv_block = _kv_block_of(skv, kv_block)
    scale = 1.0 / (hd ** 0.5)
    m = torch.full((b, h, sq), float("-inf"), device=q.device)
    l = torch.zeros((b, h, sq), device=q.device)
    acc = torch.zeros((b, h, sq, v.shape[-1]), device=q.device)
    for j0 in range(0, skv, kv_block):
        k_j, v_j = k[:, j0:j0 + kv_block], v[:, j0:j0 + kv_block]
        s = _scores(q, k_j, scale)
        if causal:
            s = _causal_fill(s, q_offset, j0)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(v_j.dtype), v_j).float()
        m = m_new
    l = l.clamp_min(1e-30)
    out = (acc / l[..., None]).transpose(1, 2).to(q.dtype)
    return out, m + torch.log(l)


def _flash_bwd(q, k, v, out, lse, g, *, causal: bool, q_offset: int,
               kv_block: int):
    """The reference's ``_flash_bwd``: P recomputed for each KV block from
    the lse; p, dp, ds, dq and each block's dk, dv in fp32 (q, k, v and g
    cast to fp32), dq summed over the blocks, each gradient cast back to
    its input's dtype at the end. dv is sized by v (MLA: hd_v != hd)."""
    b, sq, h, hd = q.shape
    skv = k.shape[1]
    kv_block = _kv_block_of(skv, kv_block)
    scale = 1.0 / (hd ** 0.5)
    gf, qf = g.float(), q.float()
    delta = torch.einsum("bqhd,bqhd->bhq", gf, out.float())
    dq = torch.zeros((b, sq, h, hd), device=q.device)
    dks, dvs = [], []
    for j0 in range(0, skv, kv_block):
        k_j, v_j = k[:, j0:j0 + kv_block], v[:, j0:j0 + kv_block]
        s = _scores(q, k_j, scale)
        if causal:
            s = _causal_fill(s, q_offset, j0)
        p = torch.exp(s - lse[..., None])                # (B, H, Sq, kvb)
        dvs.append(torch.einsum("bhqk,bqhd->bkhd", p, gf))
        dp = torch.einsum("bqhd,bkhd->bhqk", gf, v_j.float())
        ds = p * (dp - delta[..., None]) * scale
        dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, k_j.float())
        dks.append(torch.einsum("bhqk,bqhd->bkhd", ds, qf))
    return (dq.to(q.dtype), torch.cat(dks, dim=1).to(k.dtype),
            torch.cat(dvs, dim=1).to(v.dtype))


class _FlashAttention(torch.autograd.Function):
    """The reference's ``_flash_attention`` custom VJP: the forward saves
    only (q, k, v, out, lse), the backward recomputes P block by block, so
    no (B, H, Sq, kv_block) probabilities are kept for backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, kv_block):
        out, lse = _flash_fwd_core(q, k, v, causal=causal, q_offset=q_offset,
                                   kv_block=kv_block)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.knobs = dict(causal=causal, q_offset=q_offset, kv_block=kv_block)
        return out

    @staticmethod
    def backward(ctx, g):
        return (*_flash_bwd(*ctx.saved_tensors, g, **ctx.knobs), None, None,
                None)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, q_offset: int = 0,
                        q_block: int = 512,
                        kv_block: int = 1024) -> torch.Tensor:
    """Online-softmax attention. q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd).

    ``q_offset``: the position of q[0] relative to k[0]. The query axis is
    processed whole (``q_block`` is taken and ignored, as in the
    reference); the keys in ``kv_block`` chunks, ``min(kv_block, Skv)``
    of which must divide Skv (the reference asserts it: ROADMAP.md R6).
    Differentiable through ``_FlashAttention``; GQA's KV heads are
    repeated before it, so their gradients sum over each group."""
    h = q.shape[2]
    k = _expand_kv(k, h)
    v = _expand_kv(v, h)
    return _FlashAttention.apply(q, k, v, causal, int(q_offset), kv_block)


def _q_block_of(sq: int, q_block: int) -> int:
    """``min(q_block, Sq)``, which must divide Sq (the reference asserts
    it)."""
    q_block = min(q_block, sq)
    if sq % q_block:
        raise ValueError(f"sliding_window_attention: q_block={q_block} does "
                         f"not divide the {sq} queries")
    return q_block


def _swa_scores(q_i, k_i, start: int, window: int, scale: float):
    """fp32 scores of a query block against its span of the padded keys,
    NEG_INF where a key is not visible (after the query, more than
    ``window`` before it, or padding)."""
    q_block, span = q_i.shape[1], k_i.shape[1]
    qpos = start + torch.arange(q_block, device=q_i.device)
    kpos = start - window + torch.arange(span, device=q_i.device)
    visible = ((kpos[None, :] <= qpos[:, None])
               & (kpos[None, :] > qpos[:, None] - window - 1)
               & (kpos[None, :] >= 0))
    return _scores(q_i, k_i, scale).masked_fill(~visible, NEG_INF)


def _swa_fwd_core(q, kp, vp, *, window: int, q_offset: int, q_block: int):
    """q (B, Sq, H, hd); kp, vp the keys and values padded on the left by
    ``window`` rows, heads expanded. Returns out (B, Sq, H, hd) and the
    fp32 lse (B, H, Sq). ``out / l`` runs in v's dtype, as in the
    reference's ``_swa_fwd_core``."""
    sq, hd = q.shape[1], q.shape[3]
    q_block = _q_block_of(sq, q_block)
    span = window + q_block
    scale = 1.0 / (hd ** 0.5)
    outs, lses = [], []
    for i0 in range(0, sq, q_block):
        start = q_offset + i0
        v_i = vp[:, start:start + span]
        s = _swa_scores(q[:, i0:i0 + q_block], kp[:, start:start + span],
                        start, window, scale)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=-1)
        out = torch.einsum("bhqk,bkhd->bhqd", p.to(v_i.dtype), v_i)
        outs.append((out / l[..., None].to(out.dtype)).to(q.dtype))
        lses.append(m[..., 0] + torch.log(l.clamp_min(1e-30)))
    return torch.cat(outs, dim=2).transpose(1, 2), torch.cat(lses, dim=2)


def _swa_bwd(q, kp, vp, out, lse, g, *, window: int, q_offset: int,
             q_block: int):
    """The reference's ``_swa_bwd``: P recomputed for each query block;
    dK and dV accumulate in fp32 into the padded buffers, read-modify-write
    over spans that overlap by ``window`` rows. The pad rows' gradients are
    dropped by the pad's own backward."""
    sq, hd = q.shape[1], q.shape[3]
    q_block = _q_block_of(sq, q_block)
    span = window + q_block
    scale = 1.0 / (hd ** 0.5)
    gf = g.float()
    delta = torch.einsum("bqhd,bqhd->bhq", gf, out.float())
    dkp = torch.zeros(kp.shape, device=kp.device)
    dvp = torch.zeros(vp.shape, device=vp.device)
    dqs = []
    for i0 in range(0, sq, q_block):
        start = q_offset + i0
        q_i, g_i = q[:, i0:i0 + q_block], gf[:, i0:i0 + q_block]
        k_i, v_i = kp[:, start:start + span], vp[:, start:start + span]
        s = _swa_scores(q_i, k_i, start, window, scale)
        p = torch.exp(s - lse[:, :, i0:i0 + q_block, None])
        dv_i = torch.einsum("bhqk,bqhd->bkhd", p, g_i)
        dp = torch.einsum("bqhd,bkhd->bhqk", g_i, v_i.float())
        ds = p * (dp - delta[:, :, i0:i0 + q_block, None]) * scale
        dqs.append(torch.einsum("bhqk,bkhd->bqhd", ds, k_i.float()))
        dk_i = torch.einsum("bhqk,bqhd->bkhd", ds, q_i.float())
        dkp[:, start:start + span] = dkp[:, start:start + span] + dk_i
        dvp[:, start:start + span] = dvp[:, start:start + span] + dv_i
    return (torch.cat(dqs, dim=1).to(q.dtype), dkp.to(kp.dtype),
            dvp.to(vp.dtype))


class _SlidingWindowAttention(torch.autograd.Function):
    """The reference's ``_swa_attention`` custom VJP: saves (q, kp, vp,
    out, lse) and recomputes P per query block in the backward."""

    @staticmethod
    def forward(ctx, q, kp, vp, window, q_offset, q_block):
        out, lse = _swa_fwd_core(q, kp, vp, window=window, q_offset=q_offset,
                                 q_block=q_block)
        ctx.save_for_backward(q, kp, vp, out, lse)
        ctx.knobs = dict(window=window, q_offset=q_offset, q_block=q_block)
        return out

    @staticmethod
    def backward(ctx, g):
        return (*_swa_bwd(*ctx.saved_tensors, g, **ctx.knobs), None, None,
                None)


def sliding_window_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, window: int,
                             q_offset: int = 0,
                             q_block: int = 512) -> torch.Tensor:
    """Causal attention in which each token sees itself and ``window``
    predecessors. q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd). Query block i
    reads only keys [i·qb + q_offset − window, i·qb + q_offset + qb) of the
    keys padded on the left by ``window`` rows; ``min(q_block, Sq)`` must
    divide Sq (the reference asserts it). Differentiable through
    ``_SlidingWindowAttention``."""
    h = q.shape[2]
    k = _expand_kv(k, h)
    v = _expand_kv(v, h)
    kp = torch.nn.functional.pad(k, (0, 0, 0, 0, window, 0))
    vp = torch.nn.functional.pad(v, (0, 0, 0, 0, window, 0))
    return _SlidingWindowAttention.apply(q, kp, vp, window, int(q_offset),
                                         q_block)


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
