"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: seeded inputs, tolerances, and conversion between the two.

Tolerances scale with the reference's magnitude:
  fp32  max|port - jax| <= 1e-4 * max(1, max|jax|) per module,
        and <= 1e-3 * max(1, max|jax|) for the whole forward;
  bf16  max|port - jax| <= 2e-2 * max(1, max|jax|), the bound of
        tests/test_triangle.py for bf16 — one bf16 rounding of an O(1) value
        is 2**-8 relative, and the two frameworks round at a few different
        places inside a module.
"""
import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro_torch.core.evoformer import DROPOUT_SITES

# The reference runs at jax_default_matmul_precision="highest"
# (tests/conftest.py); the port's float32 products stay in full float32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

MODULE_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
FORWARD_TOL = {"float32": 1e-3}

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def assert_close(port, ref, tol: float, what: str = ""):
    """max|port - ref| <= tol * max(1, max|ref|)."""
    p, r = to_np(port), to_np(ref)
    assert p.shape == r.shape, (what, p.shape, r.shape)
    assert np.isfinite(p).all(), f"{what}: port output not finite"
    err = float(np.max(np.abs(p - r))) if p.size else 0.0
    bound = tol * max(1.0, float(np.max(np.abs(r))) if r.size else 0.0)
    assert err <= bound, f"{what}: max|port - jax| = {err:.3g} > {bound:.3g}"


def normal(rng: np.random.Generator, shape, scale: float = 1.0) -> np.ndarray:
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def both(x: np.ndarray, dtype: str):
    """The same numpy array as a JAX array and a torch CPU tensor."""
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x).astype(jdt), torch.as_tensor(x).to(tdt)


def jax_dropout_keeps(rng, evo_cfg, batch_shape) -> list[dict]:
    """The reference's own dropout masks for one call of its Evoformer
    stack, drawn as it draws them: ``split(rng, n_blocks)``, then
    ``split(., 8)`` per block, site i taking key i, and
    ``bernoulli(1 - rate)`` at the update's shape with the shared axis of
    size 1. Returned as the port's per-block dicts of fp32 0/1 tensors."""
    b, s, r = batch_shape
    keeps = []
    for block_key in jax.random.split(rng, evo_cfg.n_blocks):
        keys = jax.random.split(block_key, 8)
        block = {}
        for i, (site, axis) in enumerate(DROPOUT_SITES.items()):
            if site == "msa_row":
                shape, rate = [b, s, r, evo_cfg.d_msa], evo_cfg.dropout_msa
            else:
                shape, rate = [b, r, r, evo_cfg.d_pair], evo_cfg.dropout_pair
            shape[axis] = 1
            keep = jax.random.bernoulli(keys[i], 1.0 - rate, tuple(shape))
            block[site] = torch.as_tensor(np.asarray(keep, np.float32))
        keeps.append(block)
    return keeps


# The router's resolution in bf16: a probability (at most 1) moved by one
# bf16 rounding of the inputs upstream moves by about this much.
BF16_ROUTE_RES = 2.0 ** -8


@contextlib.contextmanager
def recorded_routing():
    """Within the scope, every call of the reference's ``moe_ffn`` and of
    the port's router appends its fp32 router probabilities (N, E), as
    numpy, to ``ref`` and ``port`` of the yielded namespace (the
    reference's through an ordered ``jax.debug.callback``, so calls inside
    ``lax.scan`` record too)."""
    from repro.models import moe as jmoe
    from repro_torch.models import moe as tmoe

    rec = types.SimpleNamespace(ref=[], port=[])
    j_orig, t_orig = jmoe.moe_ffn, tmoe.route

    def j_moe_ffn(p, x, moe):
        xf = x.reshape(-1, x.shape[-1]).astype(jnp.float32)
        probs = jax.nn.softmax(xf @ p["router"]["w"].astype(jnp.float32),
                               axis=-1)
        jax.debug.callback(lambda pr: rec.ref.append(np.asarray(pr)), probs,
                           ordered=True)
        return j_orig(p, x, moe)

    def t_route(p, xf, moe):
        out = t_orig(p, xf, moe)
        rec.port.append(out[0].detach().float().cpu().numpy())
        return out

    jmoe.moe_ffn, tmoe.route = j_moe_ffn, t_route
    try:
        yield rec
    finally:
        jmoe.moe_ffn, tmoe.route = j_orig, t_orig


def assert_same_routing(rec, top_k: int, what: str = "") -> int:
    """Each recorded router call chose the same top-k experts in both
    packages for every token whose reference margin (k-th largest
    probability less the next) exceeds ``BF16_ROUTE_RES``. Returns the
    number of tokens held."""
    assert len(rec.port) == len(rec.ref) > 0, (what, len(rec.port),
                                               len(rec.ref))
    held = 0
    for i, (pr, jr) in enumerate(zip(rec.port, rec.ref)):
        srt = np.sort(jr, axis=-1)[:, ::-1]
        sure = srt[:, top_k - 1] - srt[:, top_k] > BF16_ROUTE_RES
        want = np.sort(np.argsort(-jr, axis=-1, kind="stable")[:, :top_k], -1)
        got = np.sort(np.argsort(-pr, axis=-1, kind="stable")[:, :top_k], -1)
        bad = np.nonzero(sure & (want != got).any(-1))[0]
        assert not bad.size, f"{what} call {i}: tokens {bad} route apart"
        held += int(sure.sum())
    return held
