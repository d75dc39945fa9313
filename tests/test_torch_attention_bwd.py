"""The decoder attention's backwards against the reference's custom VJPs:
dq, dk and dv of the port's ``blockwise_attention`` and
``sliding_window_attention`` (``torch.autograd.Function``s that save only
(q, k, v, out, lse) and recompute the probabilities) against ``jax.vjp``
of the reference's ``_flash_attention`` and ``_swa_attention``, on the
same seeded inputs and cotangent. Causal and not, a query offset, GQA
(the KV gradients summed over each group), MLA's value width below the
query's, several key blocks and windows. Tolerances (torch_parity): fp32
1e-4·max(1, max|jax|), bf16 2e-2. Also: no tensor saved for backward is
larger than the inputs (the counterpart of the reference's
``test_flash_attention_bwd_saves_no_probs``), and the R6 and ``q_block``
errors raise in the backward too."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.layers import attention as jattn
from repro_torch.layers import attention as tattn
from torch_parity import (MODULE_TOL, assert_close, both, normal,
                          one_torch_thread)  # noqa: F401

DT = ["float32", "bfloat16"]


def _grads_both(fn_t, fn_j, arrays, dtype, seed, **kw):
    """(port (out, dq, dk, dv), reference's) for one cotangent."""
    pairs = [both(a, dtype) for a in arrays]
    ts = [t.requires_grad_(True) for _, t in pairs]
    out_t = fn_t(*ts, **kw)
    cot = normal(np.random.default_rng(seed), tuple(out_t.shape))
    g_j, g_t = both(cot, dtype)
    out_t.backward(g_t)

    def ref(*a):
        out_j, vjp = jax.vjp(lambda *x: fn_j(*x, **kw), *a)
        return (out_j, *vjp(g_j))

    return ((out_t, *(t.grad for t in ts)),
            jax.jit(ref)(*(j for j, _ in pairs)))


def _check(got, want, dtype, what):
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert g.dtype == {"float32": torch.float32,
                           "bfloat16": torch.bfloat16}[dtype]
        assert_close(g, w, MODULE_TOL[dtype], f"{what} {name}")


@pytest.mark.parametrize("dtype", DT)
@pytest.mark.parametrize("kv_block", [4, 8, 16, 1024])
@pytest.mark.parametrize("causal,q_offset,sq,kv,hd_v",
                         [(True, 0, 16, 2, 16), (True, 5, 11, 4, 16),
                          (False, 0, 9, 1, 16), (True, 0, 16, 4, 8)])
def test_blockwise_attention_grads(kv_block, causal, q_offset, sq, kv, hd_v,
                                   dtype):
    """4 query heads over ``kv`` KV heads (MHA, GQA 2:1, MQA), 16 keys;
    ``hd_v`` 8 is MLA's case of values narrower than the queries."""
    rng = np.random.default_rng(kv_block + sq + kv)
    arrays = (normal(rng, (2, sq, 4, 16)), normal(rng, (2, 16, kv, 16)),
              normal(rng, (2, 16, kv, hd_v)))
    got, want = _grads_both(tattn.blockwise_attention,
                            jattn.blockwise_attention, arrays, dtype,
                            seed=sq, causal=causal, q_offset=q_offset,
                            q_block=3, kv_block=kv_block)
    _check(got, want, dtype, "blockwise_attention")


@pytest.mark.parametrize("dtype", DT)
@pytest.mark.parametrize("window,q_block,q_offset,kv",
                         [(5, 4, 0, 2), (3, 12, 0, 4), (16, 6, 2, 2),
                          (1, 3, 0, 1), (8, 4, 4, 4)])
def test_sliding_window_attention_grads(window, q_block, q_offset, kv,
                                        dtype):
    """Windows narrower and wider than a query block, spans that overlap
    (dK and dV read-modify-written), a query offset, GQA and MQA."""
    rng = np.random.default_rng(window + q_block)
    arrays = (normal(rng, (2, 12, 4, 16)),
              normal(rng, (2, 12 + q_offset, kv, 16)),
              normal(rng, (2, 12 + q_offset, kv, 16)))
    got, want = _grads_both(tattn.sliding_window_attention,
                            jattn.sliding_window_attention, arrays, dtype,
                            seed=window, window=window, q_offset=q_offset,
                            q_block=q_block)
    _check(got, want, dtype, "sliding_window_attention")


@pytest.mark.parametrize("fn,kw", [
    (tattn.blockwise_attention, dict(causal=True, kv_block=64)),
    (tattn.blockwise_attention, dict(causal=False, kv_block=32)),
    (tattn.sliding_window_attention, dict(window=48, q_block=64)),
    (tattn.sliding_window_attention, dict(window=16, q_block=32)),
])
def test_backward_saves_no_probabilities(fn, kw):
    """The tensors saved for backward (through ``saved_tensors_hooks``)
    hold together no more elements than q, k and v (the keys padded by
    ``window`` rows for the sliding window), the output, the lse and the
    output again for the loss's square, and none of them has a block's
    probability shape, (B, H, S, kv_block) or (B, H, q_block, span). A
    plain autograd loop keeps one such tensor per block: B·H·S·S elements
    in all at S = 256 against blocks of 32-64."""
    b, s, h, hd = 1, 256, 2, 16
    rng = np.random.default_rng(0)
    q, k, v = (torch.as_tensor(normal(rng, (b, s, h, hd))).requires_grad_(True)
               for _ in range(3))
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = (fn(q, k, v, **kw) ** 2).sum()
    loss.backward()
    pad = kw.get("window", 0)
    budget = 3 * b * s * h * hd + 2 * b * (s + pad) * h * hd + b * h * s
    assert shapes and sum(map(np.prod, shapes)) <= budget, shapes
    if "kv_block" in kw:
        block_shapes = {(b, h, s, kw["kv_block"])}
    else:
        qb, span = kw["q_block"], kw["q_block"] + kw["window"]
        block_shapes = {(b, h, qb, span), (b, qb, h, span)}
    assert not block_shapes & set(shapes), shapes
    assert all(np.isfinite(x.grad.numpy()).all() for x in (q, k, v))


def test_backward_raises_where_the_forward_does():
    """ROADMAP.md R6 (``min(kv_block, Skv)`` must divide the keys) and the
    sliding window's ``min(q_block, Sq)`` dividing the queries: the
    backward checks them as the forward does."""
    rng = np.random.default_rng(1)
    q, k, v = (torch.as_tensor(normal(rng, (1, 12, 2, 8))) for _ in range(3))
    out, lse = tattn._flash_fwd_core(q, k, v, causal=True, q_offset=0,
                                     kv_block=4)
    with pytest.raises(ValueError, match="does not divide"):
        tattn._flash_bwd(q, k, v, out, lse, torch.ones_like(out),
                         causal=True, q_offset=0, kv_block=8)
    kp, vp = (torch.nn.functional.pad(t, (0, 0, 0, 0, 3, 0)) for t in (k, v))
    out, lse = tattn._swa_fwd_core(q, kp, vp, window=3, q_offset=0,
                                   q_block=4)
    with pytest.raises(ValueError, match="does not divide"):
        tattn._swa_bwd(q, kp, vp, out, lse, torch.ones_like(out), window=3,
                       q_offset=0, q_block=5)
    with pytest.raises(ValueError, match="does not divide"):
        tattn.sliding_window_attention(q.requires_grad_(True), k, v,
                                       window=3, q_block=5)
    with pytest.raises(AssertionError):
        jattn.sliding_window_attention(*map(jnp.asarray, (q.detach(), k, v)),
                                       window=3, q_block=5)


def test_lse_is_the_references():
    """The forward's lse, ``m + log(max(l, 1e-30))``, against the
    reference's ``_flash_fwd_core`` and ``_swa_fwd_core``, fp32."""
    rng = np.random.default_rng(2)
    arrays = [normal(rng, (2, 16, 4, 16)) for _ in range(3)]
    jq, jk, jv = map(jnp.asarray, arrays)
    tq, tk, tv = map(torch.as_tensor, arrays)
    _, lse_t = tattn._flash_fwd_core(tq, tk, tv, causal=True, q_offset=0,
                                     kv_block=4)
    _, lse_j = jattn._flash_fwd_core(jq, jk, jv, causal=True, q_offset=0,
                                     kv_block=4)
    assert_close(lse_t, lse_j, MODULE_TOL["float32"], "flash lse")
    pad = lambda a: jnp.pad(a, ((0, 0), (5, 0), (0, 0), (0, 0)))
    _, lse_j = jattn._swa_fwd_core(jq, pad(jk), pad(jv), window=5,
                                   q_offset=0, q_block=4)
    tpad = lambda t: torch.nn.functional.pad(t, (0, 0, 0, 0, 5, 0))
    _, lse_t = tattn._swa_fwd_core(tq, tpad(tk), tpad(tv), window=5,
                                   q_offset=0, q_block=4)
    assert_close(lse_t, lse_j, MODULE_TOL["float32"], "swa lse")
