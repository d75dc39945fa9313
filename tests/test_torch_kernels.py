"""The port's kernel entry points (``repro_torch.kernels.ops``) against the
JAX package: LayerNorm, gating, bias-dropout-add, fused attention, the fused
triangular multiplicative update and the fused outer-product-mean, at tiny
shapes, in fp32 and bf16, forward and backward. On the CPU the port runs
each kernel's plain PyTorch version and each op's backward; the reference
runs its Pallas kernel in interpret mode (``preset("interpret")``), its
default legs (``preset("default")``) and its jnp oracle
(``repro.kernels.ref``). Tolerances: see torch_parity."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.exec.plan import preset, use_plan
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import triangle as jtri
from repro_torch.kernels import ops, ref
from repro_torch.kernels import triangle as jtri_port
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


def test_bias_dropout_add_inference(monkeypatch):
    """The inference residual add: fp32 add cast to the residual's dtype,
    with no kernel and no plain version of one behind it; a bias takes the
    bias-dropout-add op."""
    rng = np.random.default_rng(4)
    xj, xt = both(normal(rng, (2, 5, 16)), "bfloat16")
    rj, rt = both(normal(rng, (2, 5, 16)), "bfloat16")
    bj, bt = both(normal(rng, (16,)), "float32")

    def no_op(*a):
        raise AssertionError("the bias-dropout-add op ran for a plain add")

    monkeypatch.setattr(ref, "bias_dropout_add_ref", no_op)
    got = ops.bias_dropout_add(xt, None, rt)
    want = jops.bias_dropout_add(xj, None, rj)
    assert got.dtype == torch.bfloat16
    assert_close(got, want, 0.0, "residual add")
    monkeypatch.undo()
    with_bias = ops.bias_dropout_add(xt, bt, rt)
    assert_close(with_bias, jops.bias_dropout_add(xj, bj, rj),
                 MODULE_TOL["bfloat16"], "bias, no dropout")


# (B, I, J, K, C, D, rows i whose every k is masked)
TRI_CASES = {
    "square": (2, 12, 12, 12, 8, 8, ()),
    "ragged-i-ne-j-masked-row": (2, 11, 13, 9, 8, 16, (3,)),
    "c-ne-d": (1, 10, 7, 15, 16, 8, ()),
}


def _tri_inputs(rng, bsz, ni, nj, nk, c, d, masked, dtype):
    mask = (rng.random((bsz, ni, nk)) < 0.8).astype(np.float32)
    mask[:, list(masked)] = 0.0
    arrays = {
        "a_lin": (normal(rng, (bsz, ni, nk, c)), dtype),
        "ga": (normal(rng, (bsz, ni, nk, c), 2.0), dtype),
        "mask": (mask, "float32"),
        "b_full": (normal(rng, (bsz, nj, nk, c)), dtype),
        "gamma": (1.0 + normal(rng, (c,), 0.1), "float32"),
        "beta": (normal(rng, (c,), 0.1), "float32"),
        "w_out": (normal(rng, (c, d), c ** -0.5), "float32"),
        "b_out": (normal(rng, (d,), 0.1), "float32"),
        "g_lin": (normal(rng, (bsz, ni, nj, d), 2.0), dtype),
        "g_bias": (normal(rng, (d,)), "float32"),
    }
    j, t = {}, {}
    for name, (x, dt) in arrays.items():
        j[name], t[name] = both(x, dt)
    return j, t


@pytest.mark.parametrize("dtype", DT)
@pytest.mark.parametrize("case", sorted(TRI_CASES))
def test_fused_triangle_mult(case, dtype):
    bsz, ni, nj, nk, c, d, masked = TRI_CASES[case]
    j, t = _tri_inputs(np.random.default_rng(10), bsz, ni, nj, nk, c, d,
                       masked, dtype)
    got = ops.fused_triangle_mult(*t.values())
    assert got.dtype == t["g_lin"].dtype and got.shape == (bsz, ni, nj, d)
    with use_plan(preset("interpret")):
        want = jops.fused_triangle_mult(*j.values())
    assert_close(got, want, MODULE_TOL[dtype], "vs interpret-mode Pallas")
    assert_close(got, jref.triangle_mult_ref(*j.values()), MODULE_TOL[dtype],
                 "vs jnp oracle")
    # The LN statistics the kernel returns for the recompute backward.
    _, mean, inv = ref.triangle_mult_ref(*t.values())
    _, want_mean, want_inv = jtri.fused_triangle_pallas(*j.values(),
                                                        interpret=True)
    assert_close(mean, want_mean, MODULE_TOL[dtype], "mean")
    assert_close(inv, want_inv, MODULE_TOL[dtype], "inv")
    if masked:     # a fully masked a row: LN of zeros, (0 - 0) * rsqrt(eps)
        assert float(mean[:, list(masked)].abs().max()) == 0.0
        np.testing.assert_allclose(inv[:, list(masked)].numpy(),
                                   1e-5 ** -0.5, rtol=1e-6)


# (B, S, I, J, C, D, fully masked MSA rows, fully masked residues)
OPM_CASES = {
    "square": (2, 6, 12, 12, 8, 16, (), ()),
    "ragged-i-ne-j-masked": (2, 7, 11, 13, 4, 8, (2,), (5,)),
    "c-ne-d": (1, 9, 10, 7, 8, 12, (), (0,)),
}


@pytest.mark.parametrize("dtype", DT)
@pytest.mark.parametrize("case", sorted(OPM_CASES))
def test_fused_outer_product_mean(case, dtype):
    bsz, ns, ni, nj, c, d, rows, residues = OPM_CASES[case]
    rng = np.random.default_rng(11)
    mask_a = (rng.random((bsz, ns, ni)) < 0.8).astype(np.float32)
    mask_b = (rng.random((bsz, ns, nj)) < 0.8).astype(np.float32)
    for m in (mask_a, mask_b):
        m[:, list(rows)] = 0.0
        m[..., list(residues)] = 0.0
    arrays = {
        "a": (normal(rng, (bsz, ns, ni, c)) * mask_a[..., None], dtype),
        "b_full": (normal(rng, (bsz, ns, nj, c)) * mask_b[..., None], dtype),
        "mask_a": (mask_a, "float32"),
        "mask_b": (mask_b, "float32"),
        "w": (normal(rng, (c * c, d), 1.0 / c), "float32"),
        "bias": (normal(rng, (d,)), "float32"),
    }
    j, t = {}, {}
    for name, (x, dt) in arrays.items():
        j[name], t[name] = both(x, dt)
    got = ops.fused_outer_product_mean(*t.values())
    assert got.dtype == t["a"].dtype and got.shape == (bsz, ni, nj, d)
    with use_plan(preset("interpret")):
        want = jops.fused_outer_product_mean(*j.values())
    assert_close(got, want, MODULE_TOL[dtype], "vs interpret-mode Pallas")
    assert_close(got, jref.outer_product_mean_ref(*j.values()),
                 MODULE_TOL[dtype], "vs jnp oracle")
    if residues:   # norm = 0 there: the output is the bias
        r = residues[0]
        assert_close(got[:, r], t["bias"].to(got.dtype).expand_as(got[:, r]),
                     0.0, "masked residue")


# ---------------------------------------------------------------------------
# Backwards: the gradients of sum(sin(op(...))) through the port's autograd
# Functions on the CPU against jax.grad of the reference's op, under the
# reference's default preset (its XLA legs and custom VJPs) and its
# interpret preset (its Pallas kernels in interpret mode, K6 included).
# ---------------------------------------------------------------------------

PRESETS = ["default", "interpret"]


def _port_grads(fn, tensors):
    """Gradients of sum(sin(fn(*tensors))) w.r.t. every floating tensor."""
    live = [t.detach().clone().requires_grad_(True) if t is not None else None
            for t in tensors]
    torch.sin(fn(*live).float()).sum().backward()
    return [t.grad if t is not None else None for t in live]


def _jax_grads(fn, arrays, plan):
    idx = [i for i, a in enumerate(arrays) if a is not None]

    def loss(*xs):
        full = list(arrays)
        for i, x in zip(idx, xs):
            full[i] = x
        return jnp.sum(jnp.sin(fn(*full).astype(jnp.float32)))

    with use_plan(preset(plan)):
        g = jax.grad(loss, argnums=tuple(range(len(idx))))(
            *[arrays[i] for i in idx])
    out = [None] * len(arrays)
    for i, gi in zip(idx, g):
        out[i] = gi
    return out


def _hold_grads(got, want, tol, names):
    for name, g, w in zip(names, got, want):
        if w is None:
            assert g is None, name
            continue
        assert g is not None, name
        assert_close(g, w, tol, f"d{name}")


@pytest.mark.parametrize("plan", PRESETS)
@pytest.mark.parametrize("dtype", DT)
def test_layer_norm_grad(dtype, plan):
    rng = np.random.default_rng(20)
    shape = (2, 3, 5, 24)
    xj, xt = both(normal(rng, shape, 2.0) + 0.5, dtype)
    gj, gt = both(1.0 + normal(rng, shape[-1:], 0.1), "float32")
    bj, bt = both(normal(rng, shape[-1:], 0.1), "float32")
    got = _port_grads(ops.layer_norm, [xt, gt, bt])
    assert [g.dtype for g in got] == [xt.dtype, torch.float32, torch.float32]
    want = _jax_grads(jops.layer_norm, [xj, gj, bj], plan)
    _hold_grads(got, want, MODULE_TOL[dtype], ["x", "gamma", "beta"])


@pytest.mark.parametrize("plan", PRESETS)
@pytest.mark.parametrize("dtype", DT)
def test_bias_sigmoid_mul_grad(dtype, plan):
    rng = np.random.default_rng(21)
    shape = (2, 3, 5, 16)
    gj, gt = both(normal(rng, shape, 2.0), dtype)
    vj, vt = both(normal(rng, shape), dtype)
    bgj, bgt = both(normal(rng, shape[-1:]), "float32")
    got = _port_grads(ops.bias_sigmoid_mul, [gt, bgt, vt])
    want = _jax_grads(jops.bias_sigmoid_mul, [gj, bgj, vj], plan)
    _hold_grads(got, want, MODULE_TOL[dtype], ["g", "bg", "v"])


# (N, Sq, Skv, H, D, B, bias, mask, fully masked rows): rep 3 and rep 1,
# ragged S, bias and mask on and off, fully masked rows.
ATTN_GRAD_CASES = {
    "bias-mask-rep3": (6, 12, 12, 2, 8, 2, True, True, ()),
    "bias-rep1-ragged": (3, 9, 20, 2, 8, 3, True, True, ()),
    "no-bias-no-mask": (2, 9, 9, 2, 8, 1, False, False, ()),
    "mask-only": (3, 8, 11, 1, 16, 1, False, True, ()),
    "bias-only-rep2": (4, 8, 8, 2, 8, 2, True, False, ()),
    "fully-masked-rows": (4, 8, 8, 2, 8, 2, True, True, (1, 2)),
}


@pytest.mark.parametrize("plan", PRESETS)
@pytest.mark.parametrize("dtype", DT)
@pytest.mark.parametrize("case", sorted(ATTN_GRAD_CASES))
def test_fused_attention_grad(case, dtype, plan):
    n, sq, skv, h, d, nb, wb, wm, masked = ATTN_GRAD_CASES[case]
    j, t = _attn_inputs(np.random.default_rng(22), n, sq, skv, h, d, nb, wb,
                        wm, dtype, masked)
    scale = 1.0 / np.sqrt(d)
    names = ["q", "k", "v", "bias", "mask"]

    def port(q, k, v, bias, mask):
        return ops.fused_attention(q, k, v, bias=bias, mask=mask, scale=scale)

    def ref_op(q, k, v, bias, mask):
        return jops.fused_attention(q, k, v, bias=bias, mask=mask, scale=scale)

    got = _port_grads(port, [t[k] for k in names])
    for g, name in zip(got[:3], names):
        assert g.dtype == t["q"].dtype and g.shape == t[name].shape
    want = _jax_grads(ref_op, [j[k] for k in names], plan)
    _hold_grads(got, want, MODULE_TOL[dtype], names)


@pytest.mark.parametrize("dtype", DT)
@pytest.mark.parametrize("case", sorted(c for c in ATTN_GRAD_CASES
                                        if not ATTN_GRAD_CASES[c][-1]))
def test_attention_bwd_ref_matches_reference(case, dtype):
    """The port's closed-form flash backward against the reference's
    autodiff oracle, with the forward's own (out, lse). (A fully masked row
    is left out here: the flash backward takes p = exp(s - lse) = 1 on it,
    as the reference's own backward does, where autodiff of the
    materialized softmax gives 1/Skv; test_fused_attention_grad holds that
    case against the reference's backward.)"""
    n, sq, skv, h, d, nb, wb, wm, masked = ATTN_GRAD_CASES[case]
    rng = np.random.default_rng(23)
    j, t = _attn_inputs(rng, n, sq, skv, h, d, nb, wb, wm, dtype, masked)
    scale = 0.7
    gj, gt = both(normal(rng, (n, sq, h, d)), dtype)
    out, lse = ref.attention_ref(t["q"], t["k"], t["v"], t["bias"], t["mask"],
                                 scale)
    got = ref.attention_bwd_ref(t["q"], t["k"], t["v"], gt, out, lse,
                                t["bias"], t["mask"], scale)
    want = jref.attention_bwd_ref(j["q"], j["k"], j["v"], j["bias"], j["mask"],
                                  gj, scale)
    _hold_grads(got, want, MODULE_TOL[dtype], ["q", "k", "v", "bias", "mask"])


@pytest.mark.parametrize("plan", PRESETS)
@pytest.mark.parametrize("dtype", DT)
@pytest.mark.parametrize("shared_axis", [1, 2])
@pytest.mark.parametrize("with_bias", [True, False])
def test_bias_dropout_add_grad(with_bias, shared_axis, dtype, plan):
    """The reference draws its mask inside the op; the test draws the same
    one at the reduced shape and hands it to the port."""
    rng = np.random.default_rng(24)
    shape, rate = (2, 6, 5, 16), 0.25
    xj, xt = both(normal(rng, shape), dtype)
    rj, rt = both(normal(rng, shape), dtype)
    bj, bt = both(normal(rng, shape[-1:]), "float32") if with_bias else (None, None)
    key = jax.random.PRNGKey(3)
    reduced = list(shape)
    reduced[shared_axis] = 1
    keep = torch.as_tensor(np.asarray(jax.random.bernoulli(
        key, 1.0 - rate, tuple(reduced)), np.float32))

    def port(x, b, r):
        return ops.bias_dropout_add(x, b, r, rate, keep)

    def ref_op(x, b, r):
        return jops.bias_dropout_add(x, b, r, rate=rate, rng=key,
                                     shared_axes=(shared_axis,))

    got = _port_grads(port, [xt, bt, rt])
    assert got[0].dtype == xt.dtype and got[2].dtype == rt.dtype
    want = _jax_grads(ref_op, [xj, bj, rj], plan)
    _hold_grads(got, want, MODULE_TOL[dtype], ["x", "b", "residual"])
    with use_plan(preset(plan)):
        fwd = ref_op(xj, bj, rj)
    assert_close(port(xt, bt, rt), fwd, MODULE_TOL[dtype], "forward")
    assert_close(ref.bias_dropout_add_ref(xt, bt, rt, keep, rate),
                 jref.bias_dropout_add_ref(
                     xj, bj if with_bias else jnp.zeros(16), rj,
                     jnp.broadcast_to(jnp.asarray(keep.numpy()), shape), rate),
                 MODULE_TOL[dtype], "plain version, reduced vs full mask")


TRI_NAMES = ["a_lin", "ga", "mask", "b_full", "gamma", "beta", "w_out",
             "b_out", "g_lin", "g_bias"]


@pytest.mark.parametrize("plan", PRESETS)
@pytest.mark.parametrize("dtype", DT)
@pytest.mark.parametrize("case", ["square", "ragged-i-ne-j-masked-row"])
def test_fused_triangle_mult_grad(case, dtype, plan):
    """The recompute backward from K7's saved LN mean/inv and the output,
    every input differentiated (the mask too)."""
    bsz, ni, nj, nk, c, d, masked = TRI_CASES[case]
    j, t = _tri_inputs(np.random.default_rng(25), bsz, ni, nj, nk, c, d,
                       masked, dtype)
    got = _port_grads(ops.fused_triangle_mult, [t[k] for k in TRI_NAMES])
    for g, name in zip(got, TRI_NAMES):
        assert g.dtype == t[name].dtype and g.shape == t[name].shape, name
    want = _jax_grads(jops.fused_triangle_mult, [j[k] for k in TRI_NAMES],
                      plan)
    _hold_grads(got, want, MODULE_TOL[dtype], TRI_NAMES)


def test_triangle_mult_bwd_blocks_over_j():
    """A j block smaller than J gives the one-block gradients."""
    bsz, ni, nj, nk, c, d, masked = TRI_CASES["ragged-i-ne-j-masked-row"]
    _, t = _tri_inputs(np.random.default_rng(26), bsz, ni, nj, nk, c, d,
                       masked, "float32")
    args = [t[k] for k in TRI_NAMES]
    out, mean, inv = ref.triangle_mult_ref(*args)
    res = (*args, mean, inv, out)
    dout = torch.cos(out)
    whole = jtri_port.triangle_mult_bwd(1e-5, res, dout, j_block=nj)
    blocked = jtri_port.triangle_mult_bwd(1e-5, res, dout, j_block=4)
    for name, a, b in zip(TRI_NAMES, blocked, whole):
        assert_close(a, b, 1e-5, name)


OPM_NAMES = ["a", "b_full", "mask_a", "mask_b", "w", "bias"]


@pytest.mark.parametrize("plan", PRESETS)
@pytest.mark.parametrize("dtype", DT)
@pytest.mark.parametrize("case", ["square", "ragged-i-ne-j-masked"])
def test_fused_outer_product_mean_grad(case, dtype, plan):
    """The recompute backward, with a fully masked MSA row and residue in
    the ragged case; every input differentiated (the masks too)."""
    bsz, ns, ni, nj, c, d, rows, residues = OPM_CASES[case]
    rng = np.random.default_rng(27)
    mask_a = (rng.random((bsz, ns, ni)) < 0.8).astype(np.float32)
    mask_b = (rng.random((bsz, ns, nj)) < 0.8).astype(np.float32)
    for m in (mask_a, mask_b):
        m[:, list(rows)] = 0.0
        m[..., list(residues)] = 0.0
    arrays = {
        "a": (normal(rng, (bsz, ns, ni, c)) * mask_a[..., None], dtype),
        "b_full": (normal(rng, (bsz, ns, nj, c)) * mask_b[..., None], dtype),
        "mask_a": (mask_a, "float32"),
        "mask_b": (mask_b, "float32"),
        "w": (normal(rng, (c * c, d), 1.0 / c), "float32"),
        "bias": (normal(rng, (d,)), "float32"),
    }
    j, t = {}, {}
    for name, (x, dt) in arrays.items():
        j[name], t[name] = both(x, dt)
    got = _port_grads(ops.fused_outer_product_mean, [t[k] for k in OPM_NAMES])
    for g, name in zip(got, OPM_NAMES):
        assert g.dtype == t[name].dtype and g.shape == t[name].shape, name
    want = _jax_grads(jops.fused_outer_product_mean, [j[k] for k in OPM_NAMES],
                      plan)
    _hold_grads(got, want, MODULE_TOL[dtype], OPM_NAMES)


def test_ops_build_no_graph_without_grad():
    """Under inference_mode, or with no input that needs a gradient, an op
    returns a tensor with no autograd history."""
    x = torch.randn(3, 8, requires_grad=True)
    with torch.inference_mode():
        y = ops.layer_norm(x, torch.ones(8), torch.zeros(8))
    assert y.grad_fn is None
    y = ops.bias_sigmoid_mul(x.detach(), torch.zeros(8), x.detach())
    assert y.grad_fn is None
    y = ops.bias_sigmoid_mul(x, torch.zeros(8), x)
    assert type(y.grad_fn).__name__ == "_BiasSigmoidMulBackward"
