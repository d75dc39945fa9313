"""Public entry points of the kernels, shape-polymorphic like the reference's
``kernels/ops.py``.

Routing is by the device of the tensors and nothing else: a CUDA tensor goes
to the hand-written kernel, which launches or raises; a CPU tensor goes to
the plain PyTorch version in ``ref``. There is no switch and no fallback from
a kernel to its plain version.

Each op is one ``torch.autograd.Function`` whose forward routes as above and
saves what the reference's ``*_fwd`` saves, and whose backward is the
reference's VJP in PyTorch (``_ln_bwd``, ``_bsm_bwd``, ``_bda_bwd``,
``triangle_mult_bwd``, ``opm_bwd``). Attention's backward is the flash
backward kernel on a CUDA tensor and ``ref.attention_bwd_ref`` on a CPU
tensor. Where no graph is being built (``inference_mode``, ``no_grad``, or
no input that needs a gradient) an op calls its forward directly, so
inference does no autograd work.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                 flash_attention_cuda)
from repro_torch.kernels.fused_elementwise import (bias_dropout_add_cuda,
                                                   bias_sigmoid_mul_cuda)
from repro_torch.kernels.layer_norm import layer_norm_cuda
from repro_torch.kernels.triangle import (fused_opm_cuda, fused_triangle_cuda,
                                          opm_bwd, triangle_mult_bwd)


def _on_card(t: torch.Tensor, op: str) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{op}: tensors on {t.device} are not supported")


def _builds_graph(*ts) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def _lead_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum over every axis but the last."""
    return t.sum(dim=tuple(range(t.ndim - 1)))


# ---------------------------------------------------------------------------
# LayerNorm
# ---------------------------------------------------------------------------

def _ln_fwd(x, gamma, beta, eps):
    if not _on_card(x, "layer_norm"):
        return ref.layer_norm_ref(x, gamma, beta, eps)
    return layer_norm_cuda(x.contiguous(), gamma.float().contiguous(),
                           beta.float().contiguous(), eps)


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        ctx.eps, ctx.beta_dtype = eps, beta.dtype
        ctx.save_for_backward(x, gamma)
        return _ln_fwd(x, gamma, beta, eps)

    @staticmethod
    def backward(ctx, g):
        x, gamma = ctx.saved_tensors
        xf, gf = x.float(), g.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).square().mean(dim=-1, keepdim=True)
        inv = torch.rsqrt(var + ctx.eps)
        xhat = (xf - mean) * inv
        dgamma = _lead_sum(gf * xhat)
        dbeta = _lead_sum(gf)
        gg = gf * gamma.float()
        dx = inv * (gg - gg.mean(dim=-1, keepdim=True)
                    - xhat * (gg * xhat).mean(dim=-1, keepdim=True))
        return (dx.to(x.dtype), dgamma.to(gamma.dtype),
                dbeta.to(ctx.beta_dtype), None)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis; any leading shape."""
    if _builds_graph(x, gamma, beta):
        return _LayerNorm.apply(x, gamma, beta, eps)
    return _ln_fwd(x, gamma, beta, eps)


# ---------------------------------------------------------------------------
# bias + sigmoid + mul (gating)
# ---------------------------------------------------------------------------

def _bsm_fwd(g, bg, v):
    if not _on_card(v, "bias_sigmoid_mul"):
        return ref.bias_sigmoid_mul_ref(g, bg, v)
    return bias_sigmoid_mul_cuda(g.contiguous(), bg.float().contiguous(),
                                 v.contiguous())


class _BiasSigmoidMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, bg, v):
        ctx.save_for_backward(g, bg, v)
        return _bsm_fwd(g, bg, v)

    @staticmethod
    def backward(ctx, grad):
        g, bg, v = ctx.saved_tensors
        gradf = grad.float()
        s = torch.sigmoid(g.float() + bg.float())
        dv = (gradf * s).to(v.dtype)
        dg_f = gradf * v.float() * s * (1.0 - s)
        return dg_f.to(g.dtype), _lead_sum(dg_f).to(bg.dtype), dv


def bias_sigmoid_mul(g: torch.Tensor, bg: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """sigmoid(g + bg) * v; g and v share shape (..., C), bg is (C,)."""
    if _builds_graph(g, bg, v):
        return _BiasSigmoidMul.apply(g, bg, v)
    return _bsm_fwd(g, bg, v)


# ---------------------------------------------------------------------------
# fused flash attention
# ---------------------------------------------------------------------------

def _attn_fwd(q, k, v, bias, mask, scale):
    """(out, lse) of the 4D form."""
    if not _on_card(q, "fused_attention"):
        return ref.attention_ref(q, k, v, bias, mask, scale)
    if bias is not None:
        bias = bias.contiguous()
    if mask is not None:
        mask = mask.contiguous()
    return flash_attention_cuda(q, k, v, bias, mask, scale)


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, mask, scale):
        out, lse = _attn_fwd(q, k, v, bias, mask, scale)
        ctx.scale = scale
        # Flash recompute residuals, as the reference saves them: never the
        # (N, H, Sq, Skv) probs.
        ctx.save_for_backward(q, k, v, bias, mask, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, mask, out, lse = ctx.saved_tensors
        need_dmask = mask is not None and ctx.needs_input_grad[4]
        if _on_card(q, "fused_attention"):
            bias_c = bias.contiguous() if bias is not None else None
            mask_c = mask.contiguous() if mask is not None else None
            dq, dk, dv, db, dm = flash_attention_bwd_cuda(
                q, k, v, out, g.to(q.dtype).contiguous(), lse, bias_c, mask_c,
                ctx.scale, need_dmask)
        else:
            dq, dk, dv, db, dm = ref.attention_bwd_ref(
                q, k, v, g, out, lse, bias, mask, ctx.scale)
        if db is not None:
            db = db.to(bias.dtype)
        dm = dm.to(mask.dtype) if need_dmask else None
        return dq, dk, dv, db, dm, None


def _attention(q, k, v, bias, mask, scale):
    if _builds_graph(q, k, v, bias, mask):
        return _Attention.apply(q, k, v, bias, mask, scale)
    return _attn_fwd(q, k, v, bias, mask, scale)[0]


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    bias: torch.Tensor | None = None,
                    mask: torch.Tensor | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """softmax(scale*qk^T + bias + mask) @ v, the scores never in memory.

    4D form: q (N, Sq, H, D); k, v (N, Skv, H, D); bias (B, H, Sq, Skv) with
        N % B == 0 (or (H, Sq, Skv) as B=1); mask (N, Skv) additive fp32.
    5D form (Evoformer group attention): q, k, v (B, G, S, H, D) with bias
        (B, H, S, S) shared across G and mask (B, G, S) additive; the (B, G)
        dims are flattened into N.
    ``scale`` defaults to 1/sqrt(D). Mask values must be finite (~-1e9).
    """
    d = q.shape[-1]
    if k.shape[-1] != d or v.shape[-1] != d:
        raise ValueError(f"fused_attention: head dims differ: {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    if q.ndim == 5:
        b, grp, sq, h, _ = q.shape
        skv = k.shape[2]
        qf = q.reshape(b * grp, sq, h, d)
        kf = k.reshape(b * grp, skv, h, d)
        vf = v.reshape(b * grp, skv, h, d)
        mf = mask.reshape(b * grp, skv) if mask is not None else None
        return _attention(qf, kf, vf, bias, mf, scale).reshape(q.shape)
    if bias is not None and bias.ndim == 3:
        bias = bias[None]
    return _attention(q, k, v, bias, mask, scale)


# ---------------------------------------------------------------------------
# fused triangle multiplicative update + outer-product-mean
# ---------------------------------------------------------------------------

def _tri_fwd(a_lin, ga, mask, b_full, gamma, beta, w_out, b_out, g_lin,
             g_bias, eps):
    """(out, mean, inv)."""
    if not _on_card(a_lin, "fused_triangle_mult"):
        return ref.triangle_mult_ref(a_lin, ga, mask, b_full, gamma, beta,
                                     w_out, b_out, g_lin, g_bias, eps)
    # a_lin and ga go in as they lie (the column halves of the merged
    # projections); the kernel reads the mask through its strides.
    f32 = lambda t: t.float().contiguous()
    return fused_triangle_cuda(
        a_lin, ga, mask.float(), b_full.contiguous(), f32(gamma), f32(beta),
        f32(w_out), f32(b_out), g_lin.contiguous(), f32(g_bias), eps)


class _TriangleMult(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a_lin, ga, mask, b_full, gamma, beta, w_out, b_out, g_lin,
                g_bias, eps):
        out, mean, inv = _tri_fwd(a_lin, ga, mask, b_full, gamma, beta, w_out,
                                  b_out, g_lin, g_bias, eps)
        ctx.eps = eps
        # Recompute residuals: the inputs, K7's LN statistics and the output,
        # never the (B, I, J, C) product.
        ctx.save_for_backward(a_lin, ga, mask, b_full, gamma, beta, w_out,
                              b_out, g_lin, g_bias, mean, inv, out)
        return out

    @staticmethod
    def backward(ctx, dout):
        grads = triangle_mult_bwd(ctx.eps, ctx.saved_tensors, dout,
                                  need_dmask=ctx.needs_input_grad[2])
        return (*grads, None)


def fused_triangle_mult(a_lin: torch.Tensor, ga: torch.Tensor,
                        mask: torch.Tensor, b_full: torch.Tensor,
                        gamma: torch.Tensor, beta: torch.Tensor,
                        w_out: torch.Tensor, b_out: torch.Tensor,
                        g_lin: torch.Tensor, g_bias: torch.Tensor, *,
                        eps: float = 1e-5) -> torch.Tensor:
    """sigmoid(g_lin + g_bias) * (LN_C(sum_k (a_lin·σ(ga)·mask) ⊙ b_full)
    @ w_out + b_out), the (B, I, J, C) product never in memory.

    a_lin, ga: (B, I, K, C); mask: (B, I, K); b_full: (B, J, K, C) gated and
    masked; gamma, beta: (C,); w_out: (C, D); b_out, g_bias: (D,); g_lin:
    (B, I, J, D). Returns (B, I, J, D) in g_lin's dtype.
    """
    args = (a_lin, ga, mask, b_full, gamma, beta, w_out, b_out, g_lin, g_bias)
    if _builds_graph(*args):
        return _TriangleMult.apply(*args, eps)
    return _tri_fwd(*args, eps)[0]


def _opm_fwd(a, b_full, mask_a, mask_b, w, bias):
    if not _on_card(a, "fused_outer_product_mean"):
        return ref.outer_product_mean_ref(a, b_full, mask_a, mask_b, w, bias)
    return fused_opm_cuda(a.contiguous(), b_full.contiguous(),
                          mask_a.float().contiguous(),
                          mask_b.float().contiguous(),
                          w.to(a.dtype).contiguous(),
                          bias.float().contiguous())


class _OuterProductMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b_full, mask_a, mask_b, w, bias):
        out = _opm_fwd(a, b_full, mask_a, mask_b, w, bias)
        ctx.save_for_backward(a, b_full, mask_a, mask_b, w, bias, out)
        return out

    @staticmethod
    def backward(ctx, dout):
        need = ctx.needs_input_grad
        return opm_bwd(ctx.saved_tensors, dout, need_dmask=need[2] or need[3])


def fused_outer_product_mean(a: torch.Tensor, b_full: torch.Tensor,
                             mask_a: torch.Tensor, mask_b: torch.Tensor,
                             w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """(vec(sum_s a_si ⊗ b_sj) / (sum_s mask_a·mask_b + 1e-3)) @ w + bias,
    the (B, I, J, C, C) outer product never in memory.

    a: (B, S, I, C), b_full: (B, S, J, C) masked; mask_a: (B, S, I),
    mask_b: (B, S, J); w: (C*C, D), bias: (D,). Returns (B, I, J, D) in a's
    dtype.
    """
    args = (a, b_full, mask_a, mask_b, w, bias)
    if _builds_graph(*args):
        return _OuterProductMean.apply(*args)
    return _opm_fwd(*args)


# ---------------------------------------------------------------------------
# bias + dropout + residual add
# ---------------------------------------------------------------------------

def _bda_fwd(x, b, residual, keep, rate):
    if not _on_card(residual, "bias_dropout_add"):
        return ref.bias_dropout_add_ref(x, b, residual, keep, rate)
    return bias_dropout_add_cuda(
        x.contiguous(), b.float().contiguous() if b is not None else None,
        residual.contiguous(), keep, rate)


class _BiasDropoutAdd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, b, residual, keep, rate):
        ctx.rate, ctx.x_dtype, ctx.res_dtype = rate, x.dtype, residual.dtype
        ctx.b_dtype = b.dtype if b is not None else None
        ctx.save_for_backward(keep)
        return _bda_fwd(x, b, residual, keep, rate)

    @staticmethod
    def backward(ctx, g):
        (keep,) = ctx.saved_tensors
        dx_f = g.float()
        if keep is not None:
            dx_f = dx_f * keep.float() / (1.0 - ctx.rate)
        db = _lead_sum(dx_f).to(ctx.b_dtype) if ctx.b_dtype is not None else None
        return dx_f.to(ctx.x_dtype), db, g.to(ctx.res_dtype), None, None


def bias_dropout_add(x: torch.Tensor, b: torch.Tensor | None,
                     residual: torch.Tensor, rate: float = 0.0,
                     keep: torch.Tensor | None = None) -> torch.Tensor:
    """residual + dropout(x + b, rate), summed in fp32, in the residual's
    dtype. ``keep`` is the 0/1 dropout mask, at x's shape or at a reduced
    shape that broadcasts against it (one draw shared along an axis);
    keep=None or rate=0 means no dropout, b=None no bias.

    With neither bias nor dropout this is the plain fp32 residual add, as in
    the reference, and no kernel runs: inference launches none. Otherwise the
    bias-dropout-add kernel runs on the card."""
    if keep is None or rate == 0.0:
        keep, rate = None, 0.0
        if b is None:
            return (x.float() + residual.float()).to(residual.dtype)
    if _builds_graph(x, b, residual):
        return _BiasDropoutAdd.apply(x, b, residual, keep, rate)
    return _bda_fwd(x, b, residual, keep, rate)
