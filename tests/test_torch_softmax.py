"""The port's fused softmax (K4's plain version ``ref.softmax_ref`` and the
op ``ops.fused_softmax``) and the scores-materialized ``evoformer_attention``
against the JAX package, at tiny shapes, in fp32 and bf16.

On the CPU the port runs the kernel's plain version; the reference runs its
Pallas kernel in interpret mode (``fused_softmax_pallas(interpret=True)``
and ``ops.fused_softmax`` under ``preset("interpret")``), and its default
leg. The gradients (dx, dbias, dmask) are held against ``jax.grad`` of the
reference's op. Tolerances: fp32 1e-5 * max(1, max|ref|) for the softmax
(one pass of fp32 sums in another order), bf16 2e-2 (one rounding of the
output plus the two frameworks' roundings of the input); 1e-4 for the
gradients and for the attention (see torch_parity). A row whose every logit
is -inf comes out NaN in the reference (its guarded max is 0, then 0/0):
the port must give NaN at exactly those rows."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.exec.plan import preset, use_plan
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.fused_softmax import fused_softmax_pallas
from repro.layers import attention as jattn
from repro_torch.exec import plan as tplan
from repro_torch.kernels import ops, ref
from repro_torch.layers import attention as tattn
from torch_parity import MODULE_TOL, assert_close, both, normal, to_np

DT = ["float32", "bfloat16"]
SOFTMAX_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
GRAD_TOL = 1e-4


def assert_close_nan(port, want, tol, what=""):
    """NaN at the same places, the rest as ``assert_close``."""
    p, w = to_np(port), to_np(want)
    nan = np.isnan(w)
    assert (np.isnan(p) == nan).all(), f"{what}: NaN rows differ"
    assert_close(np.where(nan, 0, p), np.where(nan, 0, w), tol, what)


def _inputs(rng, n, h, r, c, nb, with_bias, with_mask, dtype, inf_rows=(),
            big_rows=(), lead=None):
    """x (N, H, R, C); bias (B, H, R, C); mask (N, C) dropping ~20% of keys,
    every key of ``big_rows`` masked with -1e9 and of ``inf_rows`` with
    -inf. ``lead`` reshapes x's N and the mask's N (e.g. to (B, G))."""
    x = normal(rng, (n, h, r, c), 2.0)
    bias = normal(rng, (nb, h, r, c)) if with_bias else None
    mask = None
    if with_mask:
        keep = rng.random((n, c)) < 0.8
        mask = np.where(keep, 0.0, -1e9).astype(np.float32)
        mask[list(big_rows)] = -1e9
        mask[list(inf_rows)] = -np.inf
    if lead is not None:
        x = x.reshape(lead + x.shape[1:])
        if mask is not None:
            mask = mask.reshape(lead + (c,))
    xj, xt = both(x, dtype)
    bj, bt = both(bias, dtype) if bias is not None else (None, None)
    mj, mt = both(mask, "float32") if mask is not None else (None, None)
    return (xj, bj, mj), (xt, bt, mt)


# (N, H, R, C, B, bias, mask, -inf rows, -1e9 rows)
CASES = [
    (4, 2, 5, 16, 4, True, True, (), ()),
    (6, 2, 3, 40, 2, True, True, (1,), (4,)),        # rep 3, both masked rows
    (3, 1, 7, 33, 1, True, False, (), ()),           # rep 3, no mask, ragged C
    (5, 3, 2, 9, 1, False, True, (), (0, 2)),        # no bias
    (2, 2, 4, 130, 1, False, False, (), ()),         # neither, C past a lane
]
CASE_IDS = ["rep1", "rep3_masked_rows", "no_mask", "no_bias", "plain"]


@pytest.mark.parametrize("dtype", DT)
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_softmax_ref_matches_interpret_pallas(case, dtype):
    n, h, r, c, nb, wb, wm, inf_rows, big_rows = case
    rng = np.random.default_rng(0)
    (xj, bj, mj), (xt, bt, mt) = _inputs(rng, n, h, r, c, nb, wb, wm, dtype,
                                         inf_rows, big_rows)
    scale = 0.35
    got = ref.softmax_ref(xt, bt, mt, scale)
    assert got.dtype == xt.dtype
    want = fused_softmax_pallas(xj, bj, mj, scale=scale, has_bias=wb,
                                has_mask=wm, interpret=True)
    assert_close_nan(got, want, SOFTMAX_TOL[dtype], "vs interpret-mode Pallas")
    assert_close_nan(got, jref.softmax_ref(xj, bj, mj, scale),
                     SOFTMAX_TOL[dtype], "vs jnp oracle")
    if big_rows:
        # A row masked with the finite -1e9 comes out near-uniform, not NaN.
        row = to_np(got)[big_rows[0]]
        assert np.isfinite(row).all()
        assert np.allclose(row.sum(-1), 1.0, atol=2e-2)


@pytest.mark.parametrize("dtype", DT)
@pytest.mark.parametrize("form", ["4d", "4d_bias3", "5d", "5d_no_flatten",
                                  "5d_no_bias"])
def test_fused_softmax_op_matches_reference(form, dtype):
    """``ops.fused_softmax`` in its 4D and 5D forms against the reference's
    op under ``preset("interpret")`` (its Pallas kernel, flattened) and
    ``preset("default")`` (its XLA leg; unflattened in 5D); in
    ``5d_no_flatten`` the port's plain leg against the reference's
    ``allow_flatten=False``."""
    rng = np.random.default_rng(1)
    b, g, h, r = 2, 3, 2, 6
    five = form.startswith("5d")
    with_bias = form != "5d_no_bias"
    (xj, bj, mj), (xt, bt, mt) = _inputs(
        rng, b * g, h, r, r, b, with_bias, True, dtype, (), (1,),
        lead=(b, g) if five else None)
    if form == "4d_bias3":
        (xj, bj, mj), (xt, bt, mt) = _inputs(rng, 3, h, r, r, 1, True, True,
                                             dtype)
        bj, bt = bj[0], bt[0]
    # The port's 5D form on a leg without the kernel computes unflattened,
    # which is what the reference's allow_flatten=False asks for.
    kw = {"allow_flatten": False} if form == "5d_no_flatten" else {}
    port_plan = "oracle" if form == "5d_no_flatten" else "interpret"
    with tplan.use_plan(tplan.preset(port_plan)):
        got = ops.fused_softmax(xt, bias=bt, mask=mt, scale=0.5)
    assert got.shape == xt.shape and got.dtype == xt.dtype
    for name in ("interpret", "default"):
        with use_plan(preset(name)):
            want = jops.fused_softmax(xj, bias=bj, mask=mj, scale=0.5, **kw)
        assert_close(got, want, SOFTMAX_TOL[dtype], f"vs preset {name}")


@pytest.mark.parametrize("jax_preset", ["interpret", "default"])
@pytest.mark.parametrize("form", ["4d", "5d"])
def test_softmax_vjp_matches_jax_grad(form, jax_preset):
    """dx, dbias and dmask of the port's op (its ``_softmax_bwd`` in 4D,
    autograd of the unflattened plain form in 5D) against ``jax.grad`` of
    the reference's op, fp32, with a rep-3 bias and a -1e9 row."""
    rng = np.random.default_rng(2)
    b, g, h, r = 2, 3, 2, 5
    five = form == "5d"
    (xj, bj, mj), (xt, bt, mt) = _inputs(
        rng, b * g, h, r, r, b, True, True, "float32", (), (2,),
        lead=(b, g) if five else None)
    cot = normal(rng, tuple(xt.shape))
    scale = 0.4

    def jloss(x, bias, mask):
        y = jops.fused_softmax(x, bias=bias, mask=mask, scale=scale)
        return jnp.sum(jnp.sin(y) * cot)

    with use_plan(preset(jax_preset)):
        want = jax.grad(jloss, argnums=(0, 1, 2))(xj, bj, mj)
    ins = [t.clone().requires_grad_(True) for t in (xt, bt, mt)]
    y = ops.fused_softmax(*ins, scale=scale)
    got = torch.autograd.grad((torch.sin(y) * torch.as_tensor(cot)).sum(), ins)
    for name, gt, wt in zip(("dx", "dbias", "dmask"), got, want):
        assert_close(gt, wt, GRAD_TOL, name)


@pytest.mark.parametrize("dtype", DT)
@pytest.mark.parametrize("nb,with_mask", [(2, True), (1, False), (3, True)])
def test_evoformer_attention_matches_reference(nb, with_mask, dtype):
    rng = np.random.default_rng(3)
    n, s, h, d = 6, 7, 2, 8
    j, t = {}, {}
    for name in ("q", "k", "v"):
        j[name], t[name] = both(normal(rng, (n, s, h, d)), dtype)
    j["bias"], t["bias"] = both(normal(rng, (nb, h, s, s)), dtype)
    j["mask"] = t["mask"] = None
    if with_mask:
        keep = rng.random((n, s)) < 0.8
        keep[1] = False                              # a fully masked row
        j["mask"], t["mask"] = both(np.where(keep, 0.0, -1e9).astype(
            np.float32), "float32")
    got = tattn.evoformer_attention(t["q"], t["k"], t["v"], bias=t["bias"],
                                    mask=t["mask"])
    assert got.dtype == t["q"].dtype
    with use_plan(preset("interpret")):
        want = jattn.evoformer_attention(j["q"], j["k"], j["v"],
                                         bias=j["bias"], mask=j["mask"])
    assert_close(got, want, MODULE_TOL[dtype], "evoformer_attention")
