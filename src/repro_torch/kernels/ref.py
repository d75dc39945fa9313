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


def softmax_ref(x: torch.Tensor, bias: torch.Tensor | None = None,
                mask: torch.Tensor | None = None,
                scale: float = 1.0) -> torch.Tensor:
    """softmax(scale*x + bias + mask) over the last axis, summed in fp32 in
    that order, max-shifted; output in x's dtype.

    x: (N, H, R, C)
    bias: (B, H, R, C) with N % B == 0 (each bias batch element shared by
          N/B consecutive rows of x), or (H, R, C) as B=1.
    mask: (N, C) additive, broadcast over H and R.

    A row whose every logit is -inf has its max taken as 0 (the reference's
    guard, so no -inf - -inf) and then sums to 0: it comes out 0/0 = NaN,
    as in the reference. A row masked with the finite -1e9 rounds to
    near-uniform."""
    acc = x.float() * scale
    if bias is not None:
        if bias.ndim == 3:
            bias = bias[None]
        b, n = bias.shape[0], x.shape[0]
        acc = acc.reshape((b, n // b) + acc.shape[1:])
        acc = acc + bias.float()[:, None]
        acc = acc.reshape((n,) + acc.shape[2:])
    if mask is not None:
        acc = acc + mask.float()[:, None, None, :]
    m = acc.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    ex = torch.exp(acc - m)
    return (ex / ex.sum(dim=-1, keepdim=True)).to(x.dtype)


def bias_sigmoid_mul_ref(g: torch.Tensor, bg: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
    """sigmoid(g + bg) * v in fp32, output in v's dtype."""
    gf = g.float() + bg.float()
    return (torch.sigmoid(gf) * v.float()).to(v.dtype)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: torch.Tensor | None = None,
                  mask: torch.Tensor | None = None,
                  scale: float = 1.0,
                  kv_tile: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Scores-materialized attention.

    q: (N, Sq, H, D); k, v: (N, Skv, H, D)
    bias: (B, H, Sq, Skv), N % B == 0 (each bias batch element shared by N/B
          consecutive rows), or (H, Sq, Skv) as B=1.
    mask: (N, Skv) additive fp32, broadcast over H and Sq.
    kv_tile: 0, or the query rows taken at a time, which bounds the fp32
          scores at (N, H, kv_tile, Skv) (the reference's XLA leg bounds
          them at (N, H, Sq, kv_tile) with an online softmax over key
          tiles; query blocks leave every number as it is).

    Returns (out (N, Sq, H, D) in q.dtype, lse (N, H, Sq) fp32). The probs
    are cast to v's dtype before the PV product, which accumulates in fp32.
    """
    sq = q.shape[1]
    if kv_tile and 0 < kv_tile < sq:
        if bias is not None and bias.ndim == 3:
            bias = bias[None]
        blocks = [attention_ref(
            q[:, i:i + kv_tile], k, v,
            None if bias is None else bias[:, :, i:i + kv_tile], mask, scale)
            for i in range(0, sq, kv_tile)]
        return (torch.cat([o for o, _ in blocks], dim=1),
                torch.cat([l for _, l in blocks], dim=2))
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


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      do: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
                      bias: torch.Tensor | None = None,
                      mask: torch.Tensor | None = None, scale: float = 1.0):
    """The closed-form flash backward of ``attention_ref``: what the
    backward kernel computes, from the forward's saved (out, lse) and the
    cotangent ``do``, with the scores rebuilt whole.

    delta = rowsum(do * out) in fp32, p = exp(s - lse) in fp32,
    ds = p * (dp - delta) with dp = do v^T; do is cast to q's dtype before
    its products and every product accumulates in fp32 (the reference's
    rounding points). dbias sums ds over the rep = N/B groups that share a
    bias; dmask sums it over heads and query rows. Returns (dq, dk, dv in
    q's dtype, dbias in the bias's dtype or None, dmask fp32 or None)."""
    n, sq, h, d = q.shape
    f32 = torch.float32
    s = torch.einsum("nqhd,nkhd->nhqk", q.float(), k.float()) * scale
    bias4 = None
    if bias is not None:
        bias4 = bias[None] if bias.ndim == 3 else bias
        b = bias4.shape[0]
        s = s.reshape((b, n // b) + s.shape[1:])
        s = s + bias4.float()[:, None]
        s = s.reshape((n,) + s.shape[2:])
    if mask is not None:
        s = s + mask.float()[:, None, None, :]
    p = torch.exp(s - lse[..., None])                         # (N, H, Sq, Skv)
    gf = do.to(q.dtype).float()
    delta = torch.einsum("nqhd,nqhd->nhq", do.float(), out.float())
    dp = torch.einsum("nqhd,nkhd->nhqk", gf, v.float())
    ds = p * (dp - delta[..., None])
    dv = torch.einsum("nhqk,nqhd->nkhd", p, gf)
    dq = torch.einsum("nhqk,nkhd->nqhd", ds, k.float()) * scale
    dk = torch.einsum("nhqk,nqhd->nkhd", ds, q.float()) * scale
    dbias = dmask = None
    if bias is not None:
        b = bias4.shape[0]
        dbias = ds.reshape((b, n // b) + ds.shape[1:]).sum(dim=1)
        dbias = dbias.reshape(bias.shape).to(bias.dtype)
    if mask is not None:
        dmask = ds.sum(dim=(1, 2)).to(f32)
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias, dmask)


def bias_dropout_add_ref(x: torch.Tensor, b: torch.Tensor | None,
                         residual: torch.Tensor, keep: torch.Tensor | None,
                         rate: float) -> torch.Tensor:
    """residual + dropout(x + b, rate) in fp32, in the residual's dtype.
    ``keep`` is a 0/1 mask that broadcasts against x (the full shape, or the
    reduced shape with the shared axis of size 1); keep=None or rate=0 means
    no dropout, b=None no bias."""
    y = x.float()
    if b is not None:
        y = y + b.float()
    if keep is not None and rate > 0.0:
        y = y * keep.float() / (1.0 - rate)
    return (residual.float() + y).to(residual.dtype)


def triangle_mult_ref(a_lin: torch.Tensor, ga: torch.Tensor,
                      mask: torch.Tensor, b_full: torch.Tensor,
                      gamma: torch.Tensor, beta: torch.Tensor,
                      w_out: torch.Tensor, b_out: torch.Tensor,
                      g_lin: torch.Tensor, g_bias: torch.Tensor,
                      eps: float = 1e-5, tile: int = 0):
    """The fused triangular multiplicative update, materialized.

    a_lin, ga: (B, I, K, C); mask: (B, I, K); b_full: (B, J, K, C) gated
    and masked; gamma, beta: (C,); w_out: (C, D); b_out, g_bias: (D,);
    g_lin: (B, I, J, D) output-gate logits before their bias. ``tile``: 0,
    or the j block of the output computed at a time, which bounds the fp32
    product at (B, I, tile, C), as the reference's XLA leg does.

    out = sigmoid(g_lin + g_bias) * (LN_C(sum_k a ⊙ b) @ w_out + b_out) with
    a = (a_lin * sigmoid(ga)).to(dt) * mask: fp32 product and two-pass LN
    statistics, y cast to dt before the w_out product (fp32 accumulation),
    bias and gate in fp32, one cast at the end. Returns (out in g_lin's
    dtype, mean (B, I, J) fp32, inv = rsqrt(var + eps) (B, I, J) fp32).
    """
    dt = a_lin.dtype
    a = ((a_lin.float() * torch.sigmoid(ga.float())).to(dt)
         * mask.to(dt)[..., None]).float()

    def block(b_blk, gl_blk):
        o = torch.einsum("bikc,bjkc->bijc", a, b_blk.float())
        mean = o.mean(dim=-1, keepdim=True)
        var = (o - mean).square().mean(dim=-1, keepdim=True)
        inv = torch.rsqrt(var + eps)
        y = ((o - mean) * inv * gamma.float() + beta.float()).to(dt)
        z = y.float() @ w_out.to(dt).float() + b_out.float()
        s = torch.sigmoid(gl_blk.float() + g_bias.float())
        return (s * z).to(g_lin.dtype), mean[..., 0], inv[..., 0]

    nj = b_full.shape[1]
    jb = tile if tile and 0 < tile < nj else nj
    parts = [block(b_full[:, j:j + jb], g_lin[:, :, j:j + jb])
             for j in range(0, nj, jb)]
    return tuple(torch.cat(t, dim=2) for t in zip(*parts))


def outer_product_mean_ref(a: torch.Tensor, b_full: torch.Tensor,
                           mask_a: torch.Tensor, mask_b: torch.Tensor,
                           w: torch.Tensor, bias: torch.Tensor,
                           tile: int = 0) -> torch.Tensor:
    """The fused outer-product-mean, materialized.

    a: (B, S, I, C), b_full: (B, S, J, C) masked; mask_a: (B, S, I),
    mask_b: (B, S, J); w: (C*C, D), bias: (D,). ``tile``: 0, or the j block
    of the output computed at a time, which bounds the fp32 outer product
    at (B, I, tile, C, C), as the reference's XLA leg does.

    out[b,i,j] = (vec(sum_s a_si ⊗ b_sj) / (norm_ij + 1e-3)) @ w + bias with
    norm = sum_s mask_a·mask_b: fp32 outer product and norm, ov cast to a's
    dtype before the C²→D product (fp32 accumulation), output in a's dtype.
    """
    af, maf, wf = a.float(), mask_a.float(), w.to(a.dtype).float()

    def block(b_blk, mb_blk):
        o = torch.einsum("bsic,bsjd->bijcd", af, b_blk.float())
        norm = torch.einsum("bsi,bsj->bij", maf, mb_blk.float())
        ov = (o / (norm[..., None, None] + 1e-3)).to(a.dtype)
        out = ov.reshape(ov.shape[:3] + (-1,)).float() @ wf
        return (out + bias.float()).to(a.dtype)

    nj = b_full.shape[2]
    jb = tile if tile and 0 < tile < nj else nj
    return torch.cat([block(b_full[:, :, j:j + jb], mask_b[:, :, j:j + jb])
                      for j in range(0, nj, jb)], dim=2)
