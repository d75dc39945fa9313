"""Public entry points of the kernels, shape-polymorphic like the reference's
``kernels/ops.py``.

Routing: each op reads its family's leg from the current ``ExecutionPlan``
(``exec/plan.py``; ``kernel_leg``) and the device of its tensors:

    leg                                  CUDA tensor          CPU tensor
    -----------------------------------  -------------------  ------------
    auto (KernelPolicy.enabled=True)     the kernel, which    the plain
                                         launches or raises   version
    auto with enabled=False, oracle      the plain version    the plain version
    xla (the reference's XLA legs        the plain version    the plain version
      compute the same function)
    pallas                               the kernel           raise: no kernel
                                                              exists there
    interpret (the card has no           the plain version    the plain version
      interpret mode)
    attn_bwd="scan"                      ref.attention_bwd_ref for the
                                         attention backward, on either device

``KernelPolicy.interpret=True`` leaves ``auto`` as it is: on the card it
runs the kernel, as the reference's ``auto`` runs Pallas on its TPU. The
plain versions are in ``ref``. There is no fallback from a kernel to its
plain version: a CUDA tensor whose leg runs the kernel goes to it, and a
shape the kernel refuses raises.

The scores-materialized Evoformer paths ride the same legs through
``fused_attention_supported``, ``fused_triangle_supported`` and
``fused_opm_supported``. Under an ``oracle`` leg they are False. Otherwise
they hold the shape to the reference's envelope, and where the op would run
the kernel on the card also to the kernel's own (head dim, channel widths,
grid): a shape outside it takes the materialized branch, which is the
reference's own rule for out-of-envelope shapes.

Each op is one ``torch.autograd.Function`` whose forward routes as above and
saves what the reference's ``*_fwd`` saves, and whose backward is the
reference's VJP in PyTorch (``_ln_bwd``, ``_bsm_bwd``, ``_softmax_bwd``,
``_bda_bwd``, ``triangle_mult_bwd``, ``opm_bwd``). Attention's backward is
the flash backward kernel where the forward ran the kernel and the plan's
``attn_bwd`` is ``auto``, else ``ref.attention_bwd_ref``. The leg is
resolved once, when the op is called, and kept in the autograd context, so
a backward that runs after the ``use_plan`` scope closed (or on autograd's
device thread, which does not see the caller's scope) takes the forward's
leg. Where no graph is being built (``inference_mode``, ``no_grad``, or no
input that needs a gradient) an op calls its forward directly, so inference
does no autograd work.

While ``roofline.analysis.counting()`` is on, each entry point and each
backward reports its own work (``counted``, ``counted_call``; the costs in
``roofline.analysis``) and nothing inside it is counted again, so a count
is the same whether the kernel or the plain version ran. Off, that costs
one read of a module global.
"""
from __future__ import annotations

import torch

from repro_torch.exec.plan import current_plan
from repro_torch.kernels import ref
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import triangle as _tri
from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                 flash_attention_cuda)
from repro_torch.kernels.fused_elementwise import (bias_dropout_add_cuda,
                                                   bias_sigmoid_mul_cuda)
from repro_torch.kernels.fused_softmax import MAX_C as _MAX_SOFTMAX_C
from repro_torch.kernels.fused_softmax import fused_softmax_cuda
from repro_torch.kernels.layer_norm import layer_norm_cuda
from repro_torch.kernels.triangle import (BWD_J_BLOCK, fused_opm_cuda,
                                          fused_triangle_cuda, opm_bwd,
                                          triangle_mult_bwd)
from repro_torch.roofline import analysis as _roof
from repro_torch.roofline.analysis import counted, counted_call

# The reference's envelopes (src/repro/kernels/ops.py): attention head dim
# and KV length, the triangle's channels, the OPM's channel.
_REF_MAX_ATTN_D = 256
_REF_MAX_ATTN_S = 16384
_REF_MAX_TRI_C = 1024
_REF_MAX_OPM_C = 64
_DTYPES = (torch.float32, torch.bfloat16)


def kernel_leg(op: str) -> str:
    """The current plan's leg for an op family: its explicit per-op leg,
    else ``"oracle"`` under ``KernelPolicy(enabled=False)``, else
    ``"auto"``. What a leg runs on each device is the table above."""
    pol = current_plan().kernels
    leg = getattr(pol, op)
    if leg != "auto":
        return leg
    return "auto" if pol.enabled else "oracle"


def _is_cuda(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


def _on_card(t: torch.Tensor, op: str) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{op}: tensors on {t.device} are not supported")


def _runs_kernel(op: str, t: torch.Tensor) -> bool:
    """Whether the op family's current leg runs its kernel on ``t``:
    ``auto`` and ``pallas`` on a CUDA tensor do; ``pallas`` on a CPU
    tensor raises."""
    leg = kernel_leg(op)
    on_card = _on_card(t, op)
    if leg == "pallas" and not on_card:
        raise ValueError(f"{op}: the 'pallas' leg runs the CUDA kernel, and "
                         f"there is none for tensors on {t.device}")
    return on_card and leg in ("auto", "pallas")


def _builds_graph(*ts) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def _laid_out(ts):
    """The plain version's outputs laid out as the kernel's (contiguous),
    so what follows an op runs, and counts, the same on either route. It
    copies only an output that keeps a transposed input's layout. On the
    card at the main path's shapes no plain version runs under the
    default or attention-oracle plan; under oracle only LayerNorm's
    outputs on transposed views are copied, as the kernel route copies
    their inputs (``scripts/torch_plain_layouts.py``)."""
    return tuple(None if t is None else t.contiguous() for t in ts)


def _lead_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum over every axis but the last."""
    return t.sum(dim=tuple(range(t.ndim - 1)))


# ---------------------------------------------------------------------------
# LayerNorm
# ---------------------------------------------------------------------------

def _ln_fwd(x, gamma, beta, eps, kernel):
    if not kernel:
        return ref.layer_norm_ref(x, gamma, beta, eps).contiguous()
    return layer_norm_cuda(x.contiguous(), gamma.float().contiguous(),
                           beta.float().contiguous(), eps)


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps, kernel):
        ctx.eps, ctx.beta_dtype = eps, beta.dtype
        ctx.save_for_backward(x, gamma)
        return _ln_fwd(x, gamma, beta, eps, kernel)

    @staticmethod
    def backward(ctx, g):
        x, gamma = ctx.saved_tensors
        return counted_call("layer_norm_bwd", _ln_bwd, ctx, x, gamma, g)


def _ln_bwd(ctx, x, gamma, g):
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
            dbeta.to(ctx.beta_dtype), None, None)


@counted("layer_norm", _roof.layer_norm_cost)
def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis; any leading shape."""
    kernel = _runs_kernel("layer_norm", x)
    if _builds_graph(x, gamma, beta):
        return _LayerNorm.apply(x, gamma, beta, eps, kernel)
    return _ln_fwd(x, gamma, beta, eps, kernel)


# ---------------------------------------------------------------------------
# bias + sigmoid + mul (gating)
# ---------------------------------------------------------------------------

def _bsm_fwd(g, bg, v, kernel):
    if not kernel:
        return ref.bias_sigmoid_mul_ref(g, bg, v).contiguous()
    return bias_sigmoid_mul_cuda(g.contiguous(), bg.float().contiguous(),
                                 v.contiguous())


class _BiasSigmoidMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, bg, v, kernel):
        ctx.save_for_backward(g, bg, v)
        return _bsm_fwd(g, bg, v, kernel)

    @staticmethod
    def backward(ctx, grad):
        g, bg, v = ctx.saved_tensors
        return counted_call("bias_sigmoid_mul_bwd", _bsm_bwd, ctx, g, bg, v,
                            grad)


def _bsm_bwd(ctx, g, bg, v, grad):
    gradf = grad.float()
    s = torch.sigmoid(g.float() + bg.float())
    dv = (gradf * s).to(v.dtype)
    dg_f = gradf * v.float() * s * (1.0 - s)
    return dg_f.to(g.dtype), _lead_sum(dg_f).to(bg.dtype), dv, None


@counted("bias_sigmoid_mul", _roof.bias_sigmoid_mul_cost)
def bias_sigmoid_mul(g: torch.Tensor, bg: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """sigmoid(g + bg) * v; g and v share shape (..., C), bg is (C,)."""
    kernel = _runs_kernel("elementwise", v)
    if _builds_graph(g, bg, v):
        return _BiasSigmoidMul.apply(g, bg, v, kernel)
    return _bsm_fwd(g, bg, v, kernel)


# ---------------------------------------------------------------------------
# fused softmax (the scores-materialized attention's softmax)
# ---------------------------------------------------------------------------

def _softmax_fwd(x, bias, mask, scale, kernel):
    if not kernel:
        return ref.softmax_ref(x, bias, mask, scale).contiguous()
    return fused_softmax_cuda(
        x.contiguous(), bias.contiguous() if bias is not None else None,
        mask.float().contiguous() if mask is not None else None, scale)


class _Softmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bias, mask, scale, kernel):
        y = _softmax_fwd(x, bias, mask, scale, kernel)
        ctx.scale = scale
        ctx.bias_meta = (bias.shape[0], bias.dtype) if bias is not None else None
        ctx.mask_dtype = mask.dtype if mask is not None else None
        # The reference saves the output only; the logits are not kept.
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return counted_call("fused_softmax_bwd", _softmax_bwd, ctx, y, g)


def _softmax_bwd(ctx, y, g):
    """The reference's ``_softmax_bwd``: dlogits = y·(g − Σ g·y) in fp32;
    dx = dlogits·scale; dbias summed over the N/B rows that share a bias
    row; dmask summed over H and R."""
    yf, gf = y.float(), g.float()
    dlogits = yf * (gf - (gf * yf).sum(dim=-1, keepdim=True))
    dx = (dlogits * ctx.scale).to(y.dtype)
    dbias = dmask = None
    if ctx.bias_meta is not None and ctx.needs_input_grad[1]:
        b, dt = ctx.bias_meta
        n = y.shape[0]
        dbias = dlogits.reshape((b, n // b) + dlogits.shape[1:]).sum(dim=1)
        dbias = dbias.to(dt)
    if ctx.mask_dtype is not None and ctx.needs_input_grad[2]:
        dmask = dlogits.sum(dim=(1, 2)).to(ctx.mask_dtype)
    return dx, dbias, dmask, None, None


def _softmax(x, bias, mask, scale, kernel):
    if _builds_graph(x, bias, mask):
        return _Softmax.apply(x, bias, mask, scale, kernel)
    return _softmax_fwd(x, bias, mask, scale, kernel)


@counted("fused_softmax", _roof.softmax_cost)
def fused_softmax(x: torch.Tensor, bias: torch.Tensor | None = None,
                  mask: torch.Tensor | None = None,
                  scale: float = 1.0) -> torch.Tensor:
    """softmax(scale*x + bias + mask) over the last axis, summed in fp32,
    in x's dtype.

    x: (..., H, R, C), the leading dims flattened into N for the kernel.
    bias: (H, R, C) or (B, H, R, C), N % B == 0 (each bias batch element
          shared by N/B consecutive rows), or None.
    mask: additive, shape (..., C) matching x's leading dims, or None.

    5D form (group attention, Evoformer): x (B, G, H, R, C) with bias
    (B, H, R, C) shared across G and mask (B, G, C). Where the softmax leg
    does not run the kernel, or C is past its envelope (16384), this form
    computes without flattening (B, G), in plain PyTorch under autograd, as
    the reference does; otherwise (B, G) flatten into N and the kernel runs
    under the reference's VJP.
    """
    kernel = _runs_kernel("softmax", x) and x.shape[-1] <= _MAX_SOFTMAX_C
    if x.ndim == 5 and not kernel:
        acc = x.float() * scale
        if bias is not None:
            acc = acc + bias.float()[:, None]
        if mask is not None:
            acc = acc + mask.float()[:, :, None, None, :]
        return torch.softmax(acc, dim=-1).to(x.dtype)
    if x.ndim == 5:
        b, grp, h, r, c = x.shape
        xb = x.reshape(b * grp, h, r, c)
        mb = mask.reshape(-1, c) if mask is not None else None
        return _softmax(xb, bias, mb, scale, kernel).reshape(x.shape)
    h, r, c = x.shape[-3:]
    if bias is not None and bias.ndim == 3:
        bias = bias[None]
    xb = x.reshape(-1, h, r, c)
    mb = mask.reshape(-1, c) if mask is not None else None
    return _softmax(xb, bias, mb, scale, kernel).reshape(x.shape)


# ---------------------------------------------------------------------------
# fused flash attention
# ---------------------------------------------------------------------------

def fused_attention_supported(q_shape, kv_len: int | None = None,
                              dtype=None, device=None) -> bool:
    """Whether the Evoformer takes the fused attention branch for this
    query shape ((N, Sq, H, D) or (B, G, S, H, D)), KV length, dtype and
    device under the current plan; False sends it to the
    scores-materialized branch. ``device=None`` is taken as the CPU."""
    leg = kernel_leg("attention")
    if leg == "oracle":
        return False
    if dtype is not None and dtype not in _DTYPES:
        return False
    d = q_shape[-1]
    skv = q_shape[-3] if kv_len is None else kv_len
    if not (d <= _REF_MAX_ATTN_D and skv <= _REF_MAX_ATTN_S):
        return False
    if _is_cuda(device) and leg in ("auto", "pallas"):
        n = 1
        for s in q_shape[:-3]:
            n *= s
        return _fa.supported(n, q_shape[-2], d, skv)
    return True


def _attn_fwd(q, k, v, bias, mask, scale, kernel, kv_tile=0):
    """(out, lse) of the 4D form."""
    if not kernel:
        return _laid_out(ref.attention_ref(q, k, v, bias, mask, scale,
                                           kv_tile=kv_tile))
    if bias is not None:
        bias = bias.contiguous()
    if mask is not None:
        mask = mask.contiguous()
    return flash_attention_cuda(q, k, v, bias, mask, scale, kv_tile=kv_tile)


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, mask, scale, kernel, bwd_kernel, kv_tile):
        out, lse = _attn_fwd(q, k, v, bias, mask, scale, kernel, kv_tile)
        ctx.scale, ctx.bwd_kernel = scale, bwd_kernel
        # Flash recompute residuals, as the reference saves them: never the
        # (N, H, Sq, Skv) probs.
        ctx.save_for_backward(q, k, v, bias, mask, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, mask, out, lse = ctx.saved_tensors
        return counted_call(
            "fused_attention_bwd", _attn_bwd, ctx, q, k, v, bias, mask, out,
            lse, g, cost=lambda grads: _roof.attention_bwd_cost(
                q, k, v, out, g, lse, bias, mask, grads[:5]))


def _attn_bwd(ctx, q, k, v, bias, mask, out, lse, g):
    need_dmask = mask is not None and ctx.needs_input_grad[4]
    if ctx.bwd_kernel:
        bias_c = bias.contiguous() if bias is not None else None
        mask_c = mask.contiguous() if mask is not None else None
        dq, dk, dv, db, dm = flash_attention_bwd_cuda(
            q, k, v, out, g.to(q.dtype).contiguous(), lse, bias_c, mask_c,
            ctx.scale, need_dmask)
    else:
        dq, dk, dv, db, dm = _laid_out(ref.attention_bwd_ref(
            q, k, v, g, out, lse, bias, mask, ctx.scale))
    if db is not None:
        db = db.to(bias.dtype)
    dm = dm.to(mask.dtype) if need_dmask else None
    return dq, dk, dv, db, dm, None, None, None, None


def _attention(q, k, v, bias, mask, scale, kv_tile):
    kernel = _runs_kernel("attention", q)
    if _builds_graph(q, k, v, bias, mask):
        bwd_kernel = kernel and current_plan().kernels.attn_bwd != "scan"
        return _Attention.apply(q, k, v, bias, mask, scale, kernel,
                                bwd_kernel, kv_tile)
    return _attn_fwd(q, k, v, bias, mask, scale, kernel, kv_tile)[0]


@counted("fused_attention", _roof.attention_cost)
def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    bias: torch.Tensor | None = None,
                    mask: torch.Tensor | None = None,
                    scale: float | None = None,
                    kv_tile: int = 0) -> torch.Tensor:
    """softmax(scale*qk^T + bias + mask) @ v, the scores never in memory.

    4D form: q (N, Sq, H, D); k, v (N, Skv, H, D); bias (B, H, Sq, Skv) with
        N % B == 0 (or (H, Sq, Skv) as B=1); mask (N, Skv) additive fp32.
    5D form (Evoformer group attention): q, k, v (B, G, S, H, D) with bias
        (B, H, S, S) shared across G and mask (B, G, S) additive; the (B, G)
        dims are flattened into N.
    ``scale`` defaults to 1/sqrt(D). Mask values must be finite (~-1e9).
    ``kv_tile`` (0 = default; AutoChunk's ``attn_kv_tile``) goes to the
    kernel's wrapper, which has no use for it (``flash_attention_cuda``),
    and to the plain version, which takes that many query rows at a time.
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
        return _attention(qf, kf, vf, bias, mf, scale,
                          kv_tile).reshape(q.shape)
    if bias is not None and bias.ndim == 3:
        bias = bias[None]
    return _attention(q, k, v, bias, mask, scale, kv_tile)


# ---------------------------------------------------------------------------
# fused triangle multiplicative update + outer-product-mean
# ---------------------------------------------------------------------------

def fused_triangle_supported(c: int, d: int, dtype=None, device=None) -> bool:
    """Whether the Evoformer takes the fused triangle branch for channel
    width ``c``, output width ``d``, dtype and device under the current
    plan; False sends it to the materialized branch. ``device=None`` is
    taken as the CPU."""
    leg = kernel_leg("triangle")
    if leg == "oracle":
        return False
    if dtype is not None and dtype not in _DTYPES:
        return False
    if not (c <= _REF_MAX_TRI_C and d <= _REF_MAX_TRI_C):
        return False
    if _is_cuda(device) and leg in ("auto", "pallas"):
        return c in _tri.TRI_WIDTHS and d in _tri.TRI_WIDTHS
    return True


def fused_opm_supported(c: int, d: int, dtype=None, device=None) -> bool:
    """The same contract as ``fused_triangle_supported``, for the
    outer-product-mean's channel ``c`` and output width ``d``, routed by
    the plan's ``opm`` leg."""
    leg = kernel_leg("opm")
    if leg == "oracle":
        return False
    if dtype is not None and dtype not in _DTYPES:
        return False
    if not (c <= _REF_MAX_OPM_C and d <= _REF_MAX_TRI_C):
        return False
    if _is_cuda(device) and leg in ("auto", "pallas"):
        return c in _tri.OPM_C and d in _tri.OPM_D
    return True


def _tri_fwd(a_lin, ga, mask, b_full, gamma, beta, w_out, b_out, g_lin,
             g_bias, eps, kernel, tile=0):
    """(out, mean, inv)."""
    if not kernel:
        return _laid_out(ref.triangle_mult_ref(a_lin, ga, mask, b_full, gamma,
                                               beta, w_out, b_out, g_lin,
                                               g_bias, eps, tile=tile))
    # a_lin and ga go in as they lie (the column halves of the merged
    # projections); the kernel reads the mask through its strides.
    f32 = lambda t: t.float().contiguous()
    return fused_triangle_cuda(
        a_lin, ga, mask.float(), b_full.contiguous(), f32(gamma), f32(beta),
        f32(w_out), f32(b_out), g_lin.contiguous(), f32(g_bias), eps,
        tile=tile)


class _TriangleMult(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a_lin, ga, mask, b_full, gamma, beta, w_out, b_out, g_lin,
                g_bias, eps, kernel, tile):
        out, mean, inv = _tri_fwd(a_lin, ga, mask, b_full, gamma, beta, w_out,
                                  b_out, g_lin, g_bias, eps, kernel, tile)
        ctx.eps, ctx.j_block = eps, tile or BWD_J_BLOCK
        # Recompute residuals: the inputs, K7's LN statistics and the output,
        # never the (B, I, J, C) product.
        ctx.save_for_backward(a_lin, ga, mask, b_full, gamma, beta, w_out,
                              b_out, g_lin, g_bias, mean, inv, out)
        return out

    @staticmethod
    def backward(ctx, dout):
        return counted_call("fused_triangle_mult_bwd", _tri_bwd, ctx,
                            ctx.saved_tensors, dout, inner_flops=True)


def _tri_bwd(ctx, saved, dout):
    grads = triangle_mult_bwd(ctx.eps, saved, dout,
                              j_block=ctx.j_block,
                              need_dmask=ctx.needs_input_grad[2])
    return (*grads, None, None, None)


@counted("fused_triangle_mult", _roof.triangle_cost)
def fused_triangle_mult(a_lin: torch.Tensor, ga: torch.Tensor,
                        mask: torch.Tensor, b_full: torch.Tensor,
                        gamma: torch.Tensor, beta: torch.Tensor,
                        w_out: torch.Tensor, b_out: torch.Tensor,
                        g_lin: torch.Tensor, g_bias: torch.Tensor, *,
                        eps: float = 1e-5, tile: int = 0) -> torch.Tensor:
    """sigmoid(g_lin + g_bias) * (LN_C(sum_k (a_lin·σ(ga)·mask) ⊙ b_full)
    @ w_out + b_out), the (B, I, J, C) product never in memory.

    a_lin, ga: (B, I, K, C); mask: (B, I, K); b_full: (B, J, K, C) gated and
    masked; gamma, beta: (C,); w_out: (C, D); b_out, g_bias: (D,); g_lin:
    (B, I, J, D). Returns (B, I, J, D) in g_lin's dtype.

    On the card this is K7 (``kernels/triangle.py``, ``csrc/triangle_mult.cu``,
    replacing ``fused_triangle_pallas``): in bf16 a pre-pass gates a once
    into a fragment-ordered workspace about twice a_lin's size (allocated
    per call), then the main kernel's k loop reads it from L2 into
    registers for mma.sync; the L2 re-reads and the epilogue bound it. One
    launch count per call.

    ``tile`` (0 = default; AutoChunk's ``tri_k_tile``): the j block of the
    plain version and of the recompute backward (default 128), as on the
    reference's XLA leg; K7 has no use for it (``fused_triangle_cuda``).
    """
    args = (a_lin, ga, mask, b_full, gamma, beta, w_out, b_out, g_lin, g_bias)
    kernel = _runs_kernel("triangle", a_lin)
    if _builds_graph(*args):
        return _TriangleMult.apply(*args, eps, kernel, tile)
    return _tri_fwd(*args, eps, kernel, tile)[0]


def _opm_fwd(a, b_full, mask_a, mask_b, w, bias, kernel, tile=0):
    if not kernel:
        return ref.outer_product_mean_ref(a, b_full, mask_a, mask_b, w, bias,
                                          tile=tile).contiguous()
    return fused_opm_cuda(a.contiguous(), b_full.contiguous(),
                          mask_a.float().contiguous(),
                          mask_b.float().contiguous(),
                          w.to(a.dtype).contiguous(),
                          bias.float().contiguous(), tile=tile)


class _OuterProductMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b_full, mask_a, mask_b, w, bias, kernel, tile):
        out = _opm_fwd(a, b_full, mask_a, mask_b, w, bias, kernel, tile)
        ctx.j_block = tile or BWD_J_BLOCK
        ctx.save_for_backward(a, b_full, mask_a, mask_b, w, bias, out)
        return out

    @staticmethod
    def backward(ctx, dout):
        return counted_call("fused_outer_product_mean_bwd", _opm_bwd, ctx,
                            ctx.saved_tensors, dout, inner_flops=True)


def _opm_bwd(ctx, saved, dout):
    need = ctx.needs_input_grad
    return (*opm_bwd(saved, dout, j_block=ctx.j_block,
                     need_dmask=need[2] or need[3]), None, None)


@counted("fused_outer_product_mean", _roof.opm_cost)
def fused_outer_product_mean(a: torch.Tensor, b_full: torch.Tensor,
                             mask_a: torch.Tensor, mask_b: torch.Tensor,
                             w: torch.Tensor, bias: torch.Tensor, *,
                             tile: int = 0) -> torch.Tensor:
    """(vec(sum_s a_si ⊗ b_sj) / (sum_s mask_a·mask_b + 1e-3)) @ w + bias,
    the (B, I, J, C, C) outer product never in memory.

    a: (B, S, I, C), b_full: (B, S, J, C) masked; mask_a: (B, S, I),
    mask_b: (B, S, J); w: (C*C, D), bias: (D,). Returns (B, I, J, D) in a's
    dtype. ``tile`` (0 = default; AutoChunk's ``opm_s_tile``): the j block
    of the plain version and of the recompute backward (default 128), as on
    the reference's XLA leg; K8 has no use for it (``fused_opm_cuda``).
    """
    args = (a, b_full, mask_a, mask_b, w, bias)
    kernel = _runs_kernel("opm", a)
    if _builds_graph(*args):
        return _OuterProductMean.apply(*args, kernel, tile)
    return _opm_fwd(*args, kernel, tile)


# ---------------------------------------------------------------------------
# bias + dropout + residual add
# ---------------------------------------------------------------------------

def _contig(t: torch.Tensor) -> torch.Tensor:
    return t if t.is_contiguous() else t.contiguous()


def _bda_fwd(x, b, residual, keep, rate, kernel):
    if not kernel:
        return ref.bias_dropout_add_ref(x, b, residual, keep, rate).contiguous()
    if b is not None:
        b = _contig(b.float())
    return bias_dropout_add_cuda(_contig(x), b, _contig(residual), keep, rate)


class _BiasDropoutAdd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, b, residual, keep, rate, kernel):
        ctx.rate, ctx.x_dtype, ctx.res_dtype = rate, x.dtype, residual.dtype
        ctx.b_dtype = b.dtype if b is not None else None
        ctx.save_for_backward(keep)
        return _bda_fwd(x, b, residual, keep, rate, kernel)

    @staticmethod
    def backward(ctx, g):
        (keep,) = ctx.saved_tensors
        return counted_call("bias_dropout_add_bwd", _bda_bwd, ctx, keep, g)


def _bda_bwd(ctx, keep, g):
    dx_f = g.float()
    if keep is not None:
        dx_f = dx_f * keep.float() / (1.0 - ctx.rate)
    db = _lead_sum(dx_f).to(ctx.b_dtype) if ctx.b_dtype is not None else None
    return dx_f.to(ctx.x_dtype), db, g.to(ctx.res_dtype), None, None, None


@counted("bias_dropout_add", _roof.bias_dropout_add_cost)
def bias_dropout_add(x: torch.Tensor, b: torch.Tensor | None,
                     residual: torch.Tensor, rate: float = 0.0,
                     keep: torch.Tensor | None = None) -> torch.Tensor:
    """residual + dropout(x + b, rate), summed in fp32, in the residual's
    dtype. ``keep`` is the 0/1 dropout mask, at x's shape or at a reduced
    shape that broadcasts against it (one draw shared along an axis);
    keep=None or rate=0 means no dropout, b=None no bias.

    With neither bias nor dropout this is the plain fp32 residual add, as in
    the reference, and no kernel runs: inference launches none. Otherwise the
    bias-dropout-add kernel runs where the ``elementwise`` leg says so."""
    if keep is None or rate == 0.0:
        keep, rate = None, 0.0
        if b is None:
            return (x.float() + residual.float()).to(residual.dtype)
    kernel = _runs_kernel("elementwise", residual)
    if _builds_graph(x, b, residual):
        return _BiasDropoutAdd.apply(x, b, residual, keep, rate, kernel)
    return _bda_fwd(x, b, residual, keep, rate, kernel)
