"""Public entry points of the kernels, shape-polymorphic like the reference's
``kernels/ops.py``.

Routing is by the device of the tensors and nothing else: a CUDA tensor goes
to the hand-written kernel, which launches or raises; a CPU tensor goes to
the plain PyTorch version in ``ref``. There is no switch and no fallback from
a kernel to its plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.fused_elementwise import bias_sigmoid_mul_cuda
from repro_torch.kernels.layer_norm import layer_norm_cuda
from repro_torch.kernels.triangle import fused_opm_cuda, fused_triangle_cuda


def _on_card(t: torch.Tensor, op: str) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{op}: tensors on {t.device} are not supported")


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis; any leading shape."""
    if not _on_card(x, "layer_norm"):
        return ref.layer_norm_ref(x, gamma, beta, eps)
    return layer_norm_cuda(x.contiguous(), gamma.float().contiguous(),
                           beta.float().contiguous(), eps)


def bias_sigmoid_mul(g: torch.Tensor, bg: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """sigmoid(g + bg) * v; g and v share shape (..., C), bg is (C,)."""
    if not _on_card(v, "bias_sigmoid_mul"):
        return ref.bias_sigmoid_mul_ref(g, bg, v)
    return bias_sigmoid_mul_cuda(g.contiguous(), bg.float().contiguous(),
                                 v.contiguous())


def _attention(q, k, v, bias, mask, scale):
    if not _on_card(q, "fused_attention"):
        return ref.attention_ref(q, k, v, bias, mask, scale)[0]
    if bias is not None:
        bias = bias.contiguous()
    if mask is not None:
        mask = mask.contiguous()
    return flash_attention_cuda(q, k, v, bias, mask, scale)[0]


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
    if not _on_card(a_lin, "fused_triangle_mult"):
        return ref.triangle_mult_ref(a_lin, ga, mask, b_full, gamma, beta,
                                     w_out, b_out, g_lin, g_bias, eps)[0]
    # a_lin and ga go in as they lie (the column halves of the merged
    # projections); the kernel reads the mask through its strides.
    f32 = lambda t: t.float().contiguous()
    return fused_triangle_cuda(
        a_lin, ga, mask.float(), b_full.contiguous(), f32(gamma), f32(beta),
        f32(w_out), f32(b_out), g_lin.contiguous(), f32(g_bias), eps)[0]


def fused_outer_product_mean(a: torch.Tensor, b_full: torch.Tensor,
                             mask_a: torch.Tensor, mask_b: torch.Tensor,
                             w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """(vec(sum_s a_si ⊗ b_sj) / (sum_s mask_a·mask_b + 1e-3)) @ w + bias,
    the (B, I, J, C, C) outer product never in memory.

    a: (B, S, I, C), b_full: (B, S, J, C) masked; mask_a: (B, S, I),
    mask_b: (B, S, J); w: (C*C, D), bias: (D,). Returns (B, I, J, D) in a's
    dtype.
    """
    if not _on_card(a, "fused_outer_product_mean"):
        return ref.outer_product_mean_ref(a, b_full, mask_a, mask_b, w, bias)
    return fused_opm_cuda(a.contiguous(), b_full.contiguous(),
                          mask_a.float().contiguous(),
                          mask_b.float().contiguous(),
                          w.to(a.dtype).contiguous(),
                          bias.float().contiguous())


def bias_dropout_add(x: torch.Tensor, b: torch.Tensor | None,
                     residual: torch.Tensor, rate: float = 0.0) -> torch.Tensor:
    """residual + dropout(x + b, rate). Only the inference branch is ported:
    no bias and no dropout, a plain fp32 residual add cast back to the
    residual's dtype, as the reference computes it without its kernel. The
    training branch needs the ``bias_dropout_add_pallas`` port."""
    if b is not None or rate > 0.0:
        raise NotImplementedError(
            "bias_dropout_add with a bias or dropout runs the training "
            "kernel, which this port does not have yet")
    return (x.float() + residual.float()).to(residual.dtype)
