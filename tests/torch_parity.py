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
import pytest
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


# ---------------------------------------------------------------------------
# Decoder LMs
# ---------------------------------------------------------------------------

def np_tree(tree):
    """A JAX tree as numpy: floating leaves fp32, integer leaves as they
    are."""
    return jax.tree.map(
        lambda x: np.asarray(jnp.asarray(x).astype(jnp.float32))
        if jnp.issubdtype(x.dtype, jnp.floating) else np.asarray(x), tree)


def decoder_weights(jdec, cfg, seed: int):
    """The reference's init of ``cfg``, every leaf randomised: (JAX tree,
    the port's tree on the CPU)."""
    from repro_torch.weights import decoder_params_from_numpy, randomize_tree

    tree = randomize_tree(np_tree(jdec.init_model(jax.random.PRNGKey(seed),
                                                  cfg)), seed + 1)
    return (jax.tree.map(jnp.asarray, tree),
            decoder_params_from_numpy(tree, device="cpu"))


def lm_batch_both(cfg, batch: int, seq: int, seed: int):
    """Seeded tokens, next-token targets, a mask with about a fifth of the
    positions off, and (for a modality configuration) random
    ``prefix_embeds``: (JAX batch, port batch)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(batch, seq + 1)).astype(np.int32)
    arrays = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
              "mask": (rng.random((batch, seq)) < 0.8).astype(np.float32)}
    if cfg.modality and cfg.modality.n_prefix_tokens:
        arrays["prefix_embeds"] = normal(
            rng, (batch, cfg.modality.n_prefix_tokens, cfg.d_model))
    return ({k: jnp.asarray(a) for k, a in arrays.items()},
            {k: torch.as_tensor(a) for k, a in arrays.items()})


@contextlib.contextmanager
def reference_compute_dtype(jdec, dtype):
    """Within the scope the reference's ``model_forward`` computes in
    ``dtype`` (its ``lm_loss`` takes no compute dtype and runs bf16)."""
    orig = jdec.model_forward

    def forward(*args, **kw):
        kw.setdefault("compute_dtype", dtype)
        return orig(*args, **kw)

    jdec.model_forward = forward
    try:
        yield
    finally:
        jdec.model_forward = orig


def lm_loss_both(jdec, tdec, jcfg, tcfg, jp, tp, jb, tb, dtype: str):
    """``lm_loss`` and its gradients in both packages at ``dtype``
    compute: ((loss, metrics, grads as the reference's numpy tree) of the
    port, the same of the reference)."""
    from repro_torch.layers.params import tree_map
    from repro_torch.weights import decoder_params_to_numpy

    jdt, tdt = DTYPES[dtype]
    with reference_compute_dtype(jdec, jdt):
        (jl, jm), jg = jax.jit(jax.value_and_grad(
            lambda p, b: jdec.lm_loss(p, b, jcfg), has_aux=True))(jp, jb)
    live = tree_map(lambda t: t.detach().requires_grad_(True), tp)
    tl, tm = tdec.lm_loss(live, tb, tcfg, compute_dtype=tdt)
    tl.backward()
    tg = tree_map(lambda t: torch.zeros_like(t) if t.grad is None else t.grad,
                  live)
    return ((tl.detach(), {k: v.detach() for k, v in tm.items()},
             decoder_params_to_numpy(tg)), (jl, jm, np_tree(jg)))


def assert_lm_loss_close(port, ref, tol: float, what: str):
    """Loss, its metrics and every gradient leaf within ``tol``."""
    (tl, tm, tg), (jl, jm, jg) = port, ref
    assert_close(tl, jl, tol, f"{what} loss")
    for k in ("loss", "ce", "aux", "ppl"):
        assert_close(tm[k], jm[k], tol, f"{what} {k}")
    got = jax.tree_util.tree_flatten_with_path(tg)[0]
    want = jax.tree.leaves(jg)
    assert len(got) == len(want)
    for (path, g), w in zip(got, want):
        assert_close(g, w, tol, f"{what} d{jax.tree_util.keystr(path)}")


def _loss_and_grads(tdec, params, batch, cfg, remat):
    from repro_torch.layers.params import tree_leaves, tree_map

    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, _ = tdec.lm_loss(live, batch, cfg, remat=remat)
    loss.backward()
    return loss.detach(), [t.grad for t in tree_leaves(live)]


def assert_remat_changes_no_bit(jdec, tdec, arch: str):
    """``remat=True`` (each layer checkpointed and recomputed in the
    backward) against ``remat=False`` on the reduced ``arch``: the loss and
    every gradient equal to the bit on the CPU, bf16 compute."""
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config as tget

    jc, tc = jget(arch, reduced_variant=True), tget(arch, reduced_variant=True)
    _, tp = decoder_weights(jdec, jc, 2)
    _, tb = lm_batch_both(tc, 2, 32, seed=5)
    l1, g1 = _loss_and_grads(tdec, tp, tb, tc, remat=True)
    l0, g0 = _loss_and_grads(tdec, tp, tb, tc, remat=False)
    assert torch.equal(l1, l0)
    assert all(a is None and b is None or torch.equal(a, b)
               for a, b in zip(g1, g0))


def assert_smoke_forward_and_train_step(tdec, arch: str):
    """The port's counterpart of the reference's
    ``test_models_smoke.py::test_smoke_forward_and_train_step``: the port's
    own init of the reduced ``arch``, logits of the prefix and text
    positions, finite, and a loss whose gradients are finite and not all
    zero."""
    from repro_torch.configs import get_config as tget

    cfg = tget(arch, reduced_variant=True)
    params = tdec.init_model(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, size=(2, 24)))
    batch = {"tokens": toks, "targets": toks,
             "mask": torch.ones((2, 24), dtype=torch.float32)}
    p = cfg.modality.n_prefix_tokens if cfg.modality else 0
    if p:
        batch["prefix_embeds"] = torch.as_tensor(
            rng.standard_normal((2, p, cfg.d_model)), dtype=torch.float32)
    with torch.no_grad():
        out = tdec.model_forward(params, toks, cfg, mode="train",
                                 prefix_embeds=batch.get("prefix_embeds"))
    assert out["logits"].shape == (2, 24 + p, cfg.vocab)
    assert not torch.isnan(out["logits"]).any()
    loss, grads = _loss_and_grads(tdec, params, batch, cfg, remat=True)
    assert np.isfinite(float(loss))
    gn = sum(float(g.abs().sum()) for g in grads if g is not None)
    assert np.isfinite(gn) and gn > 0


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """A test module that imports this fixture runs its torch ops on one
    intra-op thread (restored after): its shapes are tiny, and the test
    run's workers share the machine's cores, where many threads a worker
    spend their time waiting on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
