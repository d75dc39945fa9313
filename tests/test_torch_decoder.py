"""The port's decoder LM against the JAX package on the same seeded inputs
and the same fully randomised weights (``randomize_tree``, carried across
by ``decoder_params_from_numpy``): the layers (RMSNorm, rope, SwiGLU, the
GELU MLP), the attention loops (blockwise over several ``kv_block``s with
GQA, sliding window, decode, rolling-cache decode), the int8 KV cache, and
``model_forward``'s prefill and three decode steps for the REDUCED variant
of each arch the port runs, logits and caches. musicgen-medium's
LayerNorm is the reference's Pallas kernel in interpret mode under
``preset("interpret")``; the port's ``ops.layer_norm`` takes its plain
version on the CPU. Tolerances (torch_parity): 1e-4·max(1, max|jax|) per
module and 1e-3 for a whole forward in fp32, 2e-2 in bf16."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.data.synthetic import lm_batches as j_lm_batches
from repro.exec.plan import preset, use_plan
from repro.layers import attention as jattn
from repro.layers import mlp as jmlp
from repro.layers import norms as jnorms
from repro.layers import rotary as jrot
from repro.models import decoder as jdec
from repro_torch.configs import get_config as tget
from repro_torch.data import lm_batches as t_lm_batches
from repro_torch.layers import attention as tattn
from repro_torch.layers import mlp as tmlp
from repro_torch.layers import norms as tnorms
from repro_torch.layers import rotary as trot
from repro_torch.layers.params import count_params
from repro_torch.models import decoder as tdec
from repro_torch.weights import (decoder_params_from_numpy,
                                 decoder_params_to_numpy, randomize_tree)
from torch_parity import (FORWARD_TOL, MODULE_TOL, assert_close,
                          assert_same_routing, both, normal, recorded_routing,
                          to_np)

DT = ["float32", "bfloat16"]
PORTED = ["qwen2-1.5b", "yi-9b", "qwen1.5-32b", "gemma3-27b",
          "llava-next-mistral-7b", "musicgen-medium", "deepseek-moe-16b",
          "deepseek-v2-236b", "hymba-1.5b", "xlstm-125m"]
COMPUTE = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np_tree(tree):
    """A JAX tree as numpy: floating leaves fp32, integer leaves as they
    are."""
    return jax.tree.map(
        lambda x: np.asarray(jnp.asarray(x).astype(jnp.float32))
        if jnp.issubdtype(x.dtype, jnp.floating) else np.asarray(x), tree)


def _weights(cfg, seed):
    """The reference's init, every leaf randomised: (JAX tree, port tree)."""
    tree = randomize_tree(_np_tree(jdec.init_model(jax.random.PRNGKey(seed),
                                                   cfg)), seed + 1)
    return (jax.tree.map(jnp.asarray, tree),
            decoder_params_from_numpy(tree, device="cpu"))


def _cache_np(port_cache):
    return decoder_params_to_numpy({"stages": port_cache})["stages"]


def _assert_caches(port_cache, ref_cache, tol, what):
    got = jax.tree.leaves(_cache_np(port_cache))
    want = jax.tree.leaves(ref_cache)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_close(g, w, tol, what)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DT)
def test_rms_norm(dtype):
    rng = np.random.default_rng(0)
    x = normal(rng, (2, 5, 48), 3.0)
    gamma = 1 + normal(rng, (48,), 0.1)
    jx, tx = both(x, dtype)
    got = tnorms.rms_norm({"gamma": torch.as_tensor(gamma)}, tx)
    want = jnorms.rms_norm({"gamma": jnp.asarray(gamma)}, jx)
    assert got.dtype == tx.dtype
    assert_close(got, want, MODULE_TOL[dtype], "rms_norm")


@pytest.mark.parametrize("dtype", DT)
@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope(dtype, theta):
    rng = np.random.default_rng(1)
    x = normal(rng, (2, 7, 3, 32))
    pos = rng.integers(0, 3000, size=(2, 7)).astype(np.int32)
    jx, tx = both(x, dtype)
    got = trot.apply_rope(tx, torch.as_tensor(pos), theta)
    want = jrot.apply_rope(jx, jnp.asarray(pos), theta)
    assert_close(got, want, MODULE_TOL[dtype], "apply_rope")


@pytest.mark.parametrize("dtype", DT)
@pytest.mark.parametrize("kind", ["swiglu", "gelu_mlp"])
def test_mlps(kind, dtype):
    init = {"swiglu": jmlp.init_swiglu, "gelu_mlp": jmlp.init_gelu_mlp}[kind]
    tree = randomize_tree(_np_tree(init(jax.random.PRNGKey(0), 32, 80)), 3)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = decoder_params_from_numpy(tree, device="cpu")
    x = normal(np.random.default_rng(2), (2, 6, 32), 2.0)
    jx, tx = both(x, dtype)
    got = getattr(tmlp, kind)(tp, tx)
    want = getattr(jmlp, kind)(jp, jx)
    assert_close(got, want, MODULE_TOL[dtype], kind)


@pytest.mark.parametrize("qk_norm,bias", [(False, True), (True, False)])
def test_project_qkv(qk_norm, bias):
    init = jattn.init_attention(jax.random.PRNGKey(0), 32, 4, 2, 16,
                                qkv_bias=bias, qk_norm=qk_norm)
    tree = randomize_tree(_np_tree(init), 4)
    tp = decoder_params_from_numpy(tree, device="cpu")
    x = normal(np.random.default_rng(3), (2, 5, 32))
    dims = (4, 2, 16)
    got = tattn.project_qkv(tp, torch.as_tensor(x), tattn.AttnDims(*dims),
                            compute_dtype=torch.float32)
    want = jattn.project_qkv(jax.tree.map(jnp.asarray, tree), jnp.asarray(x),
                             jattn.AttnDims(*dims),
                             compute_dtype=jnp.float32)
    for g, w, n in zip(got, want, "qkv"):
        assert_close(g, w, MODULE_TOL["float32"], n)
    ref_keys = set(init)
    port = tattn.init_attention(torch.Generator().manual_seed(0), 32, 4, 2,
                                16, qkv_bias=bias, qk_norm=qk_norm)
    assert set(port) == ref_keys


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _qkv(rng, b, sq, skv, h, kv, hd):
    return (normal(rng, (b, sq, h, hd)), normal(rng, (b, skv, kv, hd)),
            normal(rng, (b, skv, kv, hd)))


@pytest.mark.parametrize("dtype", DT)
@pytest.mark.parametrize("kv_block", [4, 8, 16, 1024])
@pytest.mark.parametrize("causal,q_offset,sq", [(True, 0, 16), (True, 5, 11),
                                                (False, 0, 9)])
def test_blockwise_attention(kv_block, causal, q_offset, sq, dtype):
    rng = np.random.default_rng(kv_block + sq)
    q, k, v = _qkv(rng, 2, sq, 16, 4, 2, 16)          # GQA: 4 heads, 2 KV
    (jq, tq), (jk, tk), (jv, tv) = (both(a, dtype) for a in (q, k, v))
    got = tattn.blockwise_attention(tq, tk, tv, causal=causal,
                                    q_offset=q_offset, q_block=3,
                                    kv_block=kv_block)
    want = jattn.blockwise_attention(jq, jk, jv, causal=causal,
                                     q_offset=q_offset, q_block=3,
                                     kv_block=kv_block)
    assert_close(got, want, MODULE_TOL[dtype], "blockwise_attention")


def test_blockwise_attention_kv_block_must_divide_the_keys():
    """ROADMAP.md R6: ``min(kv_block, Skv)`` must divide Skv; the reference
    asserts it, the port raises."""
    rng = np.random.default_rng(0)
    q, k, v = _qkv(rng, 1, 12, 12, 2, 2, 8)
    with pytest.raises(AssertionError):
        jattn.blockwise_attention(*map(jnp.asarray, (q, k, v)), kv_block=8)
    with pytest.raises(ValueError, match="does not divide"):
        tattn.blockwise_attention(*map(torch.as_tensor, (q, k, v)),
                                  kv_block=8)


@pytest.mark.parametrize("dtype", DT)
@pytest.mark.parametrize("window,q_block,q_offset", [(5, 4, 0), (3, 12, 0),
                                                     (16, 6, 2)])
def test_sliding_window_attention(window, q_block, q_offset, dtype):
    rng = np.random.default_rng(window)
    q, k, v = _qkv(rng, 2, 12, 12 + q_offset, 4, 2, 16)
    (jq, tq), (jk, tk), (jv, tv) = (both(a, dtype) for a in (q, k, v))
    got = tattn.sliding_window_attention(tq, tk, tv, window=window,
                                         q_offset=q_offset, q_block=q_block)
    want = jattn.sliding_window_attention(jq, jk, jv, window=window,
                                          q_offset=q_offset, q_block=q_block)
    assert_close(got, want, MODULE_TOL[dtype], "sliding_window_attention")


@pytest.mark.parametrize("dtype", DT)
@pytest.mark.parametrize("window", [None, 3])
def test_decode_attention(window, dtype):
    rng = np.random.default_rng(7)
    q, k, v = _qkv(rng, 3, 1, 10, 4, 2, 16)
    lengths = np.array([1, 6, 10], np.int32)
    (jq, tq), (jk, tk), (jv, tv) = (both(a, dtype) for a in (q, k, v))
    got = tattn.decode_attention(tq, tk, tv, torch.as_tensor(lengths),
                                 window=window)
    want = jattn.decode_attention(jq, jk, jv, jnp.asarray(lengths),
                                  window=window)
    assert_close(got, want, MODULE_TOL[dtype], "decode_attention")


@pytest.mark.parametrize("dtype", DT)
@pytest.mark.parametrize("lengths", [[0, 3, 7], [8, 12, 30]])
def test_swa_decode_attn(lengths, dtype):
    """The rolling cache of 8 rows at window 6: positions before, at and
    past the first wrap."""
    rng = np.random.default_rng(8)
    q, k, v = _qkv(rng, 3, 1, 8, 4, 2, 16)
    ln = np.asarray(lengths, np.int32)
    (jq, tq), (jk, tk), (jv, tv) = (both(a, dtype) for a in (q, k, v))
    got = tdec._swa_decode_attn(tq, tk, tv, torch.as_tensor(ln), 6)
    want = jdec._swa_decode_attn(jq, jk, jv, jnp.asarray(ln), 6)
    assert_close(got, want, MODULE_TOL[dtype], "_swa_decode_attn")


@pytest.mark.parametrize("s,window", [(5, 8), (8, 8), (13, 8)])
def test_swa_cache_from_prefill(s, window):
    rng = np.random.default_rng(s)
    k, v = normal(rng, (2, s, 2, 4)), normal(rng, (2, s, 2, 4))
    got = tdec._swa_cache_from_prefill(torch.as_tensor(k), torch.as_tensor(v),
                                       window)
    want = jdec._swa_cache_from_prefill(jnp.asarray(k), jnp.asarray(v),
                                        window)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_np(g), to_np(w))


@pytest.mark.parametrize("dtype", DT)
def test_quantize_kv_is_bit_equal(dtype):
    rng = np.random.default_rng(9)
    x = normal(rng, (2, 7, 3, 16), 2.0)
    x[0, 0, 0] = 0.0                              # the 1e-8 floor
    x[1, 2, 1, :4] = [127.0, 63.5, -0.5, 1.5]     # ties: half to even
    jx, tx = both(x, dtype)
    tq, ts = tdec._quantize_kv(tx)
    jq, js = jdec._quantize_kv(jx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(to_np(ts), to_np(js))
    np.testing.assert_array_equal(
        to_np(tdec._dequantize_kv(tq, ts)),
        to_np(jdec._dequantize_kv(jq, js)))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _forward_both(arch, dtype, *, int8=False, seed=0):
    """Prefill of two prompts (the second shorter in effect: it decodes from
    3 rows earlier) and 3 decode steps in both packages; yields (what,
    port output, reference output, port cache, reference cache)."""
    jc = jget(arch, reduced_variant=True)
    tc = tget(arch, reduced_variant=True)
    if int8:
        jc = dataclasses.replace(jc, kv_cache_int8=True)
        tc = dataclasses.replace(tc, kv_cache_int8=True)
    jp, tp = _weights(jc, seed)
    jdt, tdt = COMPUTE[dtype]
    rng = np.random.default_rng(seed + 10)
    s, horizon = 11, 24
    toks = rng.integers(0, jc.vocab, size=(2, s)).astype(np.int32)
    prefix = {}, {}
    n_prefix = 0
    if jc.modality and jc.modality.n_prefix_tokens:
        n_prefix = jc.modality.n_prefix_tokens
        pe = normal(rng, (2, n_prefix, jc.d_model))
        prefix = ({"prefix_embeds": jnp.asarray(pe)},
                  {"prefix_embeds": torch.as_tensor(pe)})
    jo = jdec.model_forward(jp, jnp.asarray(toks), jc, mode="prefill",
                            max_cache_len=horizon, compute_dtype=jdt,
                            **prefix[0])
    to = tdec.model_forward(tp, torch.as_tensor(toks), tc, mode="prefill",
                            max_cache_len=horizon, compute_dtype=tdt,
                            **prefix[1])
    yield "prefill", to, jo
    lengths = np.array([s + n_prefix, s + n_prefix - 3], np.int32)
    for i in range(3):
        nxt = rng.integers(0, jc.vocab, size=(2, 1)).astype(np.int32)
        jo = jdec.model_forward(jp, jnp.asarray(nxt), jc, mode="decode",
                                cache=jo["cache"], lengths=jnp.asarray(lengths),
                                compute_dtype=jdt)
        to = tdec.model_forward(tp, torch.as_tensor(nxt), tc, mode="decode",
                                cache=to["cache"],
                                lengths=torch.as_tensor(lengths),
                                compute_dtype=tdt)
        yield f"decode {i}", to, jo
        lengths = lengths + 1


@pytest.mark.parametrize("dtype", DT)
@pytest.mark.parametrize("arch", PORTED)
def test_model_forward_prefill_and_decode(arch, dtype):
    """Logits, caches and recurrent states, and the MoE loss ``aux``
    (summed over the layers in prefill, zero in decode). An MoE arch in
    bf16 also holds its routing: every router call chooses the same top-k
    experts in both packages for each token whose margin exceeds bf16's
    resolution (``assert_same_routing``); a nearer tie may flip."""
    tol = FORWARD_TOL.get(dtype, MODULE_TOL[dtype])
    with recorded_routing() as rec:
        for what, to, jo in _forward_both(arch, dtype):
            assert_close(to["logits"], jo["logits"], tol,
                         f"{arch} {what} logits")
            _assert_caches(to["cache"], jo["cache"], tol,
                           f"{arch} {what} cache")
            assert_close(to["aux"], jo["aux"], tol, f"{arch} {what} aux")
            if what != "prefill":
                assert float(to["aux"]) == 0.0
    cfg = tget(arch, reduced_variant=True)
    if cfg.moe:
        assert float(jo["aux"]) == 0.0 and len(rec.port) == 4
        assert assert_same_routing(rec, cfg.moe.top_k, arch) > 0


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "musicgen-medium"])
def test_model_forward_with_an_int8_kv_cache(arch):
    """The int8 values are bit-equal wherever the fp32 K/V round the same
    way; a value on the other side of a rounding boundary moves by one
    step of its scale, so the values are held as dequantised numbers."""
    tol = FORWARD_TOL["float32"]
    for what, to, jo in _forward_both(arch, "float32", int8=True):
        assert_close(to["logits"], jo["logits"], tol, f"{arch} {what} logits")
        for layer in (c for stage in to["cache"] for c in stage):
            assert {n: t.dtype for n, t in layer.items()} == {
                "k": torch.int8, "k_s": torch.bfloat16, "v": torch.int8,
                "v_s": torch.bfloat16}
        for layer_t, layer_j in zip(
                [c for stage in to["cache"] for c in stage],
                [jax.tree.map(lambda x, i=i: x[i], stage)
                 for stage in jo["cache"]
                 for i in range(jax.tree.leaves(stage)[0].shape[0])]):
            for n in ("k", "v"):
                assert_close(tdec._dequantize_kv(layer_t[n], layer_t[n + "_s"],
                                                 torch.float32),
                             jdec._dequantize_kv(layer_j[n], layer_j[n + "_s"],
                                                 jnp.float32),
                             tol, f"{arch} {what} int8 {n}")


@pytest.mark.parametrize("plan", ["default", "interpret"])
def test_musicgen_layer_norm_against_the_pallas_kernel(plan):
    """musicgen-medium's every LayerNorm is K1: the reference under
    ``preset("interpret")`` runs ``layer_norm_pallas`` in interpret mode,
    under ``preset("default")`` its CPU leg; the port's plain version on
    the CPU matches both, in a whole prefill."""
    jc = jget("musicgen-medium", reduced_variant=True)
    tc = tget("musicgen-medium", reduced_variant=True)
    jp, tp = _weights(jc, 5)
    toks = np.random.default_rng(6).integers(0, jc.vocab, size=(1, 16))
    with use_plan(preset(plan)):
        jo = jdec.model_forward(jp, jnp.asarray(toks, jnp.int32), jc,
                                mode="prefill", max_cache_len=16,
                                compute_dtype=jnp.float32)
    to = tdec.model_forward(tp, torch.as_tensor(toks), tc, mode="prefill",
                            max_cache_len=16, compute_dtype=torch.float32)
    assert_close(to["logits"], jo["logits"], FORWARD_TOL["float32"], plan)


def test_train_mode_equals_prefill_logits():
    jc = jget("gemma3-27b", reduced_variant=True)
    tc = tget("gemma3-27b", reduced_variant=True)
    jp, tp = _weights(jc, 2)
    toks = np.random.default_rng(3).integers(0, jc.vocab, size=(2, 9))
    to = tdec.model_forward(tp, torch.as_tensor(toks), tc,
                            compute_dtype=torch.float32)
    jo = jdec.model_forward(jp, jnp.asarray(toks, jnp.int32), jc,
                            remat=False, compute_dtype=jnp.float32)
    assert to["cache"] is None
    assert_close(to["logits"], jo["logits"], FORWARD_TOL["float32"], "train")
    pre = tdec.model_forward(tp, torch.as_tensor(toks), tc, mode="prefill",
                             compute_dtype=torch.float32)
    torch.testing.assert_close(pre["logits"], to["logits"], rtol=0, atol=0)


@pytest.mark.parametrize("arch", PORTED)
def test_init_and_cache_have_the_references_structure(arch):
    """The port's own init and zero cache: the reference's keys, shapes and
    dtypes once its stages are stacked; and the weight conversion is its
    own inverse."""
    jc = jget(arch, reduced_variant=True)
    tc = tget(arch, reduced_variant=True)
    ref = _np_tree(jdec.init_model(jax.random.PRNGKey(0), jc))
    port = tdec.init_model(torch.Generator().manual_seed(0), tc)
    got = decoder_params_to_numpy(port)
    assert (jax.tree.structure(got) == jax.tree.structure(ref))
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        assert g.shape == w.shape
    assert count_params(port) == sum(x.size for x in jax.tree.leaves(ref))
    back = decoder_params_to_numpy(decoder_params_from_numpy(ref,
                                                             device="cpu"))
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(g, w)
    jcache = jdec.init_cache(jc, 3, 20)
    tcache = tdec.init_cache(tc, 3, 20)
    for g, w in zip(jax.tree.leaves(_cache_np(tcache)),
                    jax.tree.leaves(jcache)):
        assert g.shape == w.shape


def test_window_sees_one_key_more_in_prefill_than_in_decode():
    """ROADMAP.md R9: past the window a prefill and the same tokens
    decoded differ (a prefill token sees ``window`` predecessors, a
    decode step ``window`` positions with itself); reduced hymba-1.5b,
    window 16, 20 tokens then 2 decoded, fp32. Both packages show it,
    and the port's logits are the reference's in both modes."""
    jc = jget("hymba-1.5b", reduced_variant=True)
    tc = tget("hymba-1.5b", reduced_variant=True)
    jp, tp = _weights(jc, 7)
    toks = np.random.default_rng(8).integers(0, jc.vocab, size=(1, 22))
    f32 = (dict(compute_dtype=jnp.float32), dict(compute_dtype=torch.float32))
    gaps = []
    for fwd, p, cfg, arr, kw in (
            (jdec.model_forward, jp, jc, lambda a: jnp.asarray(a, jnp.int32),
             f32[0]),
            (tdec.model_forward, tp, tc, torch.as_tensor, f32[1])):
        out = fwd(p, arr(toks[:, :20]), cfg, mode="prefill",
                  max_cache_len=22, **kw)
        steps = []
        for i in (20, 21):
            out = fwd(p, arr(toks[:, i:i + 1]), cfg, mode="decode",
                      cache=out["cache"], lengths=arr(np.array([i])), **kw)
            steps.append(to_np(out["logits"][:, 0]))
        whole = to_np(fwd(p, arr(toks), cfg, mode="prefill",
                          **kw)["logits"][:, 20:])
        gaps.append((np.stack(steps, 1), whole))
    (j_steps, j_whole), (t_steps, t_whole) = gaps
    assert np.abs(j_steps - j_whole).max() > 1e-2      # the caveat
    assert_close(t_steps, j_steps, FORWARD_TOL["float32"], "decode")
    assert_close(t_whole, j_whole, FORWARD_TOL["float32"], "recompute")


@pytest.mark.parametrize("kind", ["conv", "rwkv+dense", "attention",
                                  "mamba+moe"])
def test_unknown_mixer_raises_in_both_packages(kind):
    """An unknown mixer raises ``ValueError`` where the reference's does:
    in ``init_layer`` and in the cache's shape."""
    jc = dataclasses.replace(jget("qwen2-1.5b", reduced_variant=True),
                             stages=((kind, 1),))
    tc = dataclasses.replace(tget("qwen2-1.5b", reduced_variant=True),
                             stages=((kind, 1),))
    with pytest.raises(ValueError, match="unknown mixer"):
        jdec.init_model(jax.random.PRNGKey(0), jc)
    with pytest.raises(ValueError, match="unknown mixer"):
        tdec.init_model(torch.Generator().manual_seed(0), tc)
    with pytest.raises(ValueError):
        jdec.init_cache(jc, 1, 8)
    with pytest.raises(ValueError):
        tdec.init_cache(tc, 1, 8)


def test_lm_batches_are_byte_identical():
    for kw in ({"vocab": 512, "batch": 2, "seq": 9, "seed": 3},
               {"vocab": 2048, "batch": 1, "seq": 256, "seed": 0}):
        gj, gt = j_lm_batches(**kw), t_lm_batches(**kw)
        for _ in range(2):
            a, b = next(gj), next(gt)
            for f in ("tokens", "targets", "mask"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
                assert getattr(a, f).dtype == getattr(b, f).dtype
