"""The port's kernel entry points (``repro_torch.kernels.ops``) against the
JAX package: LayerNorm, gating and fused attention, at tiny shapes, in fp32
and bf16. On the CPU the port runs each kernel's plain PyTorch version; the
reference runs its Pallas kernel in interpret mode (``preset("interpret")``)
and its jnp oracle (``repro.kernels.ref``). Tolerances: see torch_parity."""
import numpy as np
import pytest
import torch

from repro.exec.plan import preset, use_plan
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref
from torch_parity import MODULE_TOL, assert_close, both, normal

DT = ["float32", "bfloat16"]


@pytest.mark.parametrize("dtype", DT)
@pytest.mark.parametrize("shape", [(5, 100), (2, 3, 5, 16), (2, 7, 384)])
def test_layer_norm(shape, dtype):
    rng = np.random.default_rng(0)
    c = shape[-1]
    xj, xt = both(normal(rng, shape, 2.0) + 0.5, dtype)
    gj, gt = both(1.0 + normal(rng, (c,), 0.1), "float32")
    bj, bt = both(normal(rng, (c,), 0.1), "float32")
    got = ops.layer_norm(xt, gt, bt)
    assert got.dtype == xt.dtype
    with use_plan(preset("interpret")):
        want = jops.layer_norm(xj, gj, bj)
    assert_close(got, want, MODULE_TOL[dtype], "vs interpret-mode Pallas")
    assert_close(got, jref.layer_norm_ref(xj, gj, bj), MODULE_TOL[dtype],
                 "vs jnp oracle")


@pytest.mark.parametrize("dtype", DT)
@pytest.mark.parametrize("shape", [(6, 24), (2, 3, 5, 16)])
def test_bias_sigmoid_mul(shape, dtype):
    rng = np.random.default_rng(1)
    gj, gt = both(normal(rng, shape, 2.0), dtype)
    vj, vt = both(normal(rng, shape), dtype)
    bgj, bgt = both(normal(rng, shape[-1:]), "float32")
    got = ops.bias_sigmoid_mul(gt, bgt, vt)
    assert got.dtype == vt.dtype
    with use_plan(preset("interpret")):
        want = jops.bias_sigmoid_mul(gj, bgj, vj)
    assert_close(got, want, MODULE_TOL[dtype], "vs interpret-mode Pallas")
    assert_close(got, jref.bias_sigmoid_mul_ref(gj, bgj, vj),
                 MODULE_TOL[dtype], "vs jnp oracle")


def _attn_inputs(rng, n, sq, skv, h, d, nb, with_bias, with_mask, dtype,
                 masked_rows=()):
    q = normal(rng, (n, sq, h, d))
    k = normal(rng, (n, skv, h, d))
    v = normal(rng, (n, skv, h, d))
    bias = normal(rng, (nb, h, sq, skv)) if with_bias else None
    mask = None
    if with_mask:
        keep = rng.random((n, skv)) < 0.8
        keep[list(masked_rows)] = False     # every key of these rows masked
        mask = np.where(keep, 0.0, -1e9).astype(np.float32)
    j, t = {}, {}
    for name, x, dt in (("q", q, dtype), ("k", k, dtype), ("v", v, dtype),
                        ("bias", bias, dtype), ("mask", mask, "float32")):
        if x is None:
            j[name] = t[name] = None
        else:
            j[name], t[name] = both(x, dt)
    return j, t


# (N, Sq, Skv, H, D, B, bias, mask, fully-masked rows)
ATTN_CASES = {
    "bias-mask-rep3": (6, 12, 12, 2, 8, 2, True, True, ()),
    "no-bias-no-mask": (2, 9, 9, 2, 8, 1, False, False, ()),
    "mask-only": (3, 8, 8, 1, 16, 1, False, True, ()),
    "bias-only": (4, 8, 8, 2, 8, 4, True, False, ()),
    "ragged-skv": (2, 8, 20, 2, 8, 1, True, True, ()),
    "fully-masked-rows": (4, 8, 8, 2, 8, 2, True, True, (1, 2)),
}


@pytest.mark.parametrize("dtype", DT)
@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_fused_attention_4d(case, dtype):
    n, sq, skv, h, d, nb, wb, wm, masked = ATTN_CASES[case]
    rng = np.random.default_rng(2)
    j, t = _attn_inputs(rng, n, sq, skv, h, d, nb, wb, wm, dtype, masked)
    scale = 1.0 / np.sqrt(d)
    got = ops.fused_attention(t["q"], t["k"], t["v"], bias=t["bias"],
                              mask=t["mask"], scale=scale)
    assert got.dtype == t["q"].dtype
    with use_plan(preset("interpret")):
        want = jops.fused_attention(j["q"], j["k"], j["v"], bias=j["bias"],
                                    mask=j["mask"], scale=scale)
    assert_close(got, want, MODULE_TOL[dtype], "vs interpret-mode Pallas")
    out_r, lse_r = jref.attention_ref(j["q"], j["k"], j["v"], j["bias"],
                                      j["mask"], scale)
    out_p, lse_p = ref.attention_ref(t["q"], t["k"], t["v"], t["bias"],
                                     t["mask"], scale)
    assert_close(got, out_r, MODULE_TOL[dtype], "vs jnp oracle")
    assert_close(out_p, out_r, MODULE_TOL[dtype], "plain version vs oracle")
    assert_close(lse_p, lse_r, MODULE_TOL["float32"], "lse vs oracle")


@pytest.mark.parametrize("dtype", DT)
@pytest.mark.parametrize("with_bias", [True, False])
def test_fused_attention_5d(with_bias, dtype):
    """Evoformer group form: q/k/v (B, G, S, H, D), bias (B, H, S, S) shared
    across G, mask (B, G, S); q/k/v are column slices of one projection."""
    rng = np.random.default_rng(3)
    b, g, s, h, d = 2, 3, 10, 2, 8
    qkv = normal(rng, (b, g, s, 3 * h * d))
    bias = normal(rng, (b, h, s, s)) if with_bias else None
    keep = rng.random((b, g, s)) < 0.7
    keep[0, 1] = False
    mask = np.where(keep, 0.0, -1e9).astype(np.float32)
    qkv_j, qkv_t = both(qkv, dtype)
    split = lambda y: [y[..., i * h * d:(i + 1) * h * d].reshape(
        y.shape[:-1] + (h, d)) for i in range(3)]
    qj, kj, vj = split(qkv_j)
    qt, kt, vt = split(qkv_t)
    bj, bt = both(bias, dtype) if with_bias else (None, None)
    mj, mt = both(mask, "float32")
    got = ops.fused_attention(qt, kt, vt, bias=bt, mask=mt)
    assert got.shape == (b, g, s, h, d)
    with use_plan(preset("interpret")):
        want = jops.fused_attention(qj, kj, vj, bias=bj, mask=mj)
    assert_close(got, want, MODULE_TOL[dtype], "vs interpret-mode Pallas")


def test_bias_dropout_add_inference():
    """The inference residual add: fp32 add cast to the residual's dtype."""
    rng = np.random.default_rng(4)
    xj, xt = both(normal(rng, (2, 5, 16)), "bfloat16")
    rj, rt = both(normal(rng, (2, 5, 16)), "bfloat16")
    got = ops.bias_dropout_add(xt, None, rt)
    want = jops.bias_dropout_add(xj, None, rj)
    assert got.dtype == torch.bfloat16
    assert_close(got, want, 0.0, "residual add")
    with pytest.raises(NotImplementedError):
        ops.bias_dropout_add(xt, torch.zeros(16), rt)
