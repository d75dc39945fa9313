"""The port's recurrent sequence mixers against the JAX package: the Mamba
block (``models/ssm.py``, hymba's SSM heads) and the xLSTM blocks
(``models/xlstm.py``), on the same seeded inputs and the same fully
randomised weights, outputs and the states they return, in fp32
(1e-4·max(1, max|jax|)) and bf16 (2e-2); then the reference's own
properties (``tests/test_recurrent.py``) run on the port: chunked = stepwise
recurrence, chunk-size invariance, causality, state continuation.

The port's Mamba scan is a sequential loop over time where the reference
runs ``jax.lax.associative_scan``: the two round differently by a few fp32
ulps, inside the module tolerance."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SSMConfig as JSSM
from repro.models import ssm as jssm
from repro.models import xlstm as jx
from repro_torch.configs.base import SSMConfig as TSSM
from repro_torch.models import ssm as tssm
from repro_torch.models import xlstm as tx
from repro_torch.weights import decoder_params_from_numpy, randomize_tree
from torch_parity import MODULE_TOL, assert_close, both, normal, to_np

B, S, D, H = 2, 16, 32, 4
DT = ["float32", "bfloat16"]
SSM_KW = dict(state_dim=8, expand=2, conv_width=4)


def _np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(jnp.asarray(x, jnp.float32)),
                        tree)


def _params(init_tree, seed):
    """(reference tree, port tree) of one randomised draw."""
    tree = randomize_tree(_np_tree(init_tree), seed)
    return (jax.tree.map(jnp.asarray, tree),
            decoder_params_from_numpy(tree, device="cpu"))


def _x(seed, s=S, scale=0.5):
    return normal(np.random.default_rng(seed), (B, s, D), scale)


def _assert_state(got, want, tol, what):
    for k in want:
        assert_close(got[k], want[k], tol, f"{what} state {k}")


def _mamba():
    return _params(jssm.init_mamba(jax.random.PRNGKey(3), D, JSSM(**SSM_KW)),
                   4)


def _mlstm():
    return _params(jx.init_mlstm(jax.random.PRNGKey(1), D, H), 5)


def _slstm():
    return _params(jx.init_slstm(jax.random.PRNGKey(2), D, H), 6)


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DT)
def test_mamba_forward_and_decode_match_the_reference(dtype):
    jp, tp = _mamba()
    jx_, tx_ = both(_x(0), dtype)
    tol = MODULE_TOL[dtype]
    got, gst = tssm.mamba_forward(tp, tx_, TSSM(**SSM_KW))
    want, wst = jssm.mamba_forward(jp, jx_, JSSM(**SSM_KW))
    assert got.dtype == tx_.dtype and gst["conv"].dtype == tx_.dtype
    assert_close(got, want, tol, "mamba_forward")
    _assert_state(gst, wst, tol, "mamba_forward")
    # Decode from the prefill's state, the conv state cast to the cache's
    # fp32 as the engine's slot copy casts it.
    gst = {"h": gst["h"], "conv": gst["conv"].float()}
    wst = {"h": wst["h"], "conv": wst["conv"].astype(jnp.float32)}
    for t in range(3):
        jn, tn = both(_x(10 + t, s=1), dtype)
        got, gst = tssm.mamba_decode(tp, tn, gst, TSSM(**SSM_KW))
        want, wst = jssm.mamba_decode(jp, jn, wst, JSSM(**SSM_KW))
        assert_close(got, want, tol, f"mamba_decode {t}")
        _assert_state(gst, wst, tol, f"mamba_decode {t}")


@pytest.mark.parametrize("dtype", DT)
@pytest.mark.parametrize("chunk", [4, 16, 256])
def test_mlstm_forward_and_decode_match_the_reference(chunk, dtype):
    jp, tp = _mlstm()
    jx_, tx_ = both(_x(1), dtype)
    tol = MODULE_TOL[dtype]
    got, gst = tx.mlstm_forward(tp, tx_, H, chunk=chunk)
    want, wst = jx.mlstm_forward(jp, jx_, H, chunk=chunk)
    assert_close(got, want, tol, "mlstm_forward")
    _assert_state(gst, wst, tol, "mlstm_forward")
    for t in range(3):
        jn, tn = both(_x(20 + t, s=1), dtype)
        got, gst = tx.mlstm_decode(tp, tn, gst, H)
        want, wst = jx.mlstm_decode(jp, jn, wst, H)
        assert_close(got, want, tol, f"mlstm_decode {t}")
        _assert_state(gst, wst, tol, f"mlstm_decode {t}")


@pytest.mark.parametrize("dtype", DT)
def test_slstm_forward_and_decode_match_the_reference(dtype):
    jp, tp = _slstm()
    jx_, tx_ = both(_x(2), dtype)
    tol = MODULE_TOL[dtype]
    got, gst = tx.slstm_forward(tp, tx_)
    want, wst = jx.slstm_forward(jp, jx_)
    assert_close(got, want, tol, "slstm_forward")
    _assert_state(gst, wst, tol, "slstm_forward")
    for t in range(3):
        jn, tn = both(_x(30 + t, s=1), dtype)
        got, gst = tx.slstm_decode(tp, tn, gst)
        want, wst = jx.slstm_decode(jp, jn, wst)
        assert_close(got, want, tol, f"slstm_decode {t}")
        _assert_state(gst, wst, tol, f"slstm_decode {t}")


def test_slstm_recurrent_product_runs_in_fp32_under_bf16():
    """``dense(r, h)`` casts the weight to the fp32 state's dtype."""
    _, tp = _slstm()
    seen = []
    orig = tx.dense

    def spy(p, x, *a, **k):
        if p is tp["r"]:
            seen.append(x.dtype)
        return orig(p, x, *a, **k)

    tx.dense = spy
    try:
        tx.slstm_forward(tp, torch.as_tensor(_x(3)).to(torch.bfloat16))
    finally:
        tx.dense = orig
    assert seen and set(seen) == {torch.float32}


@pytest.mark.parametrize("s,chunk", [(12, 8), (10, 4)])
def test_mlstm_chunk_must_divide_the_sequence(s, chunk):
    """ROADMAP.md R8: ``S % min(chunk, S)`` must be 0; the reference
    asserts it, the port raises ``ValueError`` at the same point."""
    jp, tp = _mlstm()
    x = _x(4, s=s)
    with pytest.raises(AssertionError):
        jx.mlstm_forward(jp, jnp.asarray(x), H, chunk=chunk)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tx.mlstm_forward(tp, torch.as_tensor(x), H, chunk=chunk)


@pytest.mark.parametrize("dtype", DT)
def test_conv1d_with_and_without_state(dtype):
    jp, tp = _mamba()
    rng = np.random.default_rng(5)
    x = normal(rng, (B, 5, 2 * D))
    state = normal(rng, (B, 3, 2 * D))
    jx_, tx_ = both(x, dtype)
    for st in (None, state):
        got = tssm._conv1d(tp, tx_, TSSM(**SSM_KW),
                           None if st is None else torch.as_tensor(st))
        want = jssm._conv1d(jp, jx_, JSSM(**SSM_KW),
                            None if st is None else jnp.asarray(st))
        for g, w in zip(got, want):
            assert_close(g, w, MODULE_TOL[dtype], "_conv1d")


@pytest.mark.parametrize("init,args", [
    ("mlstm", (D, H)), ("slstm", (D, H)), ("mamba", (D,))])
def test_inits_have_the_references_structure(init, args):
    if init == "mamba":
        ref = jssm.init_mamba(jax.random.PRNGKey(0), *args, JSSM(**SSM_KW))
        port = tssm.init_mamba(torch.Generator().manual_seed(0), *args,
                               TSSM(**SSM_KW))
    else:
        ref = getattr(jx, f"init_{init}")(jax.random.PRNGKey(0), *args)
        port = getattr(tx, f"init_{init}")(torch.Generator().manual_seed(0),
                                           *args)
    ref = _np_tree(ref)
    got = jax.tree.map(lambda t: t.numpy(), port)
    assert jax.tree.structure(got) == jax.tree.structure(ref)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        assert g.shape == w.shape
    if init == "mamba":      # the deterministic leaves (log: to an ulp)
        for k in ("D", "conv_b"):
            np.testing.assert_array_equal(got[k], ref[k])
        np.testing.assert_allclose(got["A_log"], ref["A_log"], rtol=1e-6)


# ---------------------------------------------------------------------------
# the reference's properties, on the port
# ---------------------------------------------------------------------------

def test_mlstm_chunked_equals_recurrent():
    _, tp = _mlstm()
    x = torch.as_tensor(_x(0))
    out_c, st_c = tx.mlstm_forward(tp, x, H, chunk=4)
    st = tx.init_mlstm_state(B, 2 * D, H)
    outs = []
    for t in range(S):
        o, st = tx.mlstm_decode(tp, x[:, t:t + 1], st, H)
        outs.append(o)
    np.testing.assert_allclose(to_np(out_c), to_np(torch.cat(outs, 1)),
                               atol=2e-4)
    np.testing.assert_allclose(to_np(st_c["C"]), to_np(st["C"]), rtol=1e-3,
                               atol=1e-4)


def test_mlstm_chunk_size_invariance():
    _, tp = _mlstm()
    x = torch.as_tensor(_x(0))
    o1, _ = tx.mlstm_forward(tp, x, H, chunk=4)
    for chunk in (8, 16):
        o2, _ = tx.mlstm_forward(tp, x, H, chunk=chunk)
        np.testing.assert_allclose(to_np(o1), to_np(o2), atol=2e-4)


def test_mlstm_state_continuation():
    """forward(first half)'s state fed to forward(second half) equals the
    full forward."""
    _, tp = _mlstm()
    x = torch.as_tensor(_x(0))
    full, _ = tx.mlstm_forward(tp, x, H, chunk=4)
    h1, st = tx.mlstm_forward(tp, x[:, :S // 2], H, chunk=4)
    h2, _ = tx.mlstm_forward(tp, x[:, S // 2:], H, chunk=4, state=st)
    np.testing.assert_allclose(to_np(torch.cat([h1, h2], 1)), to_np(full),
                               atol=2e-4)


def test_slstm_scan_equals_stepwise():
    _, tp = _slstm()
    x = torch.as_tensor(_x(0))
    out_s, _ = tx.slstm_forward(tp, x)
    st = tx.init_slstm_state(B, D)
    outs = []
    for t in range(S):
        o, st = tx.slstm_decode(tp, x[:, t:t + 1], st)
        outs.append(o)
    np.testing.assert_allclose(to_np(out_s), to_np(torch.cat(outs, 1)),
                               atol=1e-5)


def test_mamba_scan_equals_stepwise():
    """The port's scan is the decode step in a loop: the states agree to
    the bit, the outputs to the reference's tolerance."""
    _, tp = _mamba()
    ssm = TSSM(**SSM_KW)
    x = torch.as_tensor(_x(0))
    out_m, st_m = tssm.mamba_forward(tp, x, ssm)
    st = tssm.init_mamba_state(B, 2 * D, ssm)
    outs = []
    for t in range(S):
        o, st = tssm.mamba_decode(tp, x[:, t:t + 1], st, ssm)
        outs.append(o)
    np.testing.assert_allclose(to_np(out_m), to_np(torch.cat(outs, 1)),
                               atol=2e-4)
    np.testing.assert_allclose(to_np(st_m["h"]), to_np(st["h"]), rtol=1e-3,
                               atol=1e-4)


@pytest.mark.parametrize("block", ["mamba", "mlstm", "slstm"])
def test_causality(block):
    """A change to the second half of the sequence leaves the first half's
    outputs as they were."""
    _, tp = {"mamba": _mamba, "mlstm": _mlstm, "slstm": _slstm}[block]()
    x = torch.as_tensor(_x(0))
    x2 = x.clone()
    x2[:, S // 2:] += 10.0
    run = {"mamba": lambda v: tssm.mamba_forward(tp, v, TSSM(**SSM_KW)),
           "mlstm": lambda v: tx.mlstm_forward(tp, v, H, chunk=4),
           "slstm": lambda v: tx.slstm_forward(tp, v)}[block]
    y1, _ = run(x)
    y2, _ = run(x2)
    np.testing.assert_allclose(to_np(y1[:, :S // 2]), to_np(y2[:, :S // 2]),
                               atol=1e-5)
