"""The port's DeepSeek parts against the JAX package: the MoE FFN
(``models/moe.py``) and Multi-head Latent Attention (``models/mla.py``), on
the same seeded inputs and the same fully randomised weights, in fp32
(1e-4·max(1, max|jax|)) and bf16 (2e-2); then the reference's own MoE
properties (``tests/test_moe.py``) run on the port.

Routing in bf16. Both packages route in fp32 from the same bf16 input here,
so the router's choices are held equal for every token whose top-k margin
exceeds bf16's resolution (``torch_parity.assert_same_routing``); a nearer
tie may flip between the two libraries' roundings."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis_compat import given, settings, st

from repro.configs.base import MLAConfig as JMLA
from repro.configs.base import MoEConfig as JMoE
from repro.models import mla as jmla
from repro.models import moe as jmoe
from repro_torch.configs.base import MLAConfig as TMLA
from repro_torch.configs.base import MoEConfig as TMoE
from repro_torch.models import mla as tmla
from repro_torch.models import moe as tmoe
from repro_torch.weights import (decoder_params_from_numpy, randomize_tree,
                                 random_params_like)
from torch_parity import (MODULE_TOL, assert_close, assert_same_routing, both,
                          normal, recorded_routing, to_np)

D = 64
MOE = dict(n_experts=4, top_k=2, n_shared=1, d_ff_expert=32,
           capacity_factor=2.0)
DT = ["float32", "bfloat16"]


def _np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(jnp.asarray(x, jnp.float32)),
                        tree)


def _moe_params(seed=0, **kw):
    cfg = dict(MOE, **kw)
    tree = randomize_tree(_np_tree(jmoe.init_moe(jax.random.PRNGKey(seed), D,
                                                 JMoE(**cfg))), seed + 1)
    return (jax.tree.map(jnp.asarray, tree),
            decoder_params_from_numpy(tree, device="cpu"), JMoE(**cfg),
            TMoE(**cfg))


def _port(seed=0, **kw):
    return _moe_params(seed, **kw)[1], TMoE(**dict(MOE, **kw))


# ---------------------------------------------------------------------------
# MoE against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DT)
@pytest.mark.parametrize("groups,cf", [(1, 2.0), (1, 1.0), (4, 1.0),
                                       (3, 1.25), (1, 100.0)])
def test_moe_ffn_matches_the_reference(groups, cf, dtype):
    """Capacity binding (cf 1.0, 1.25) and not (100), one group, four
    groups, and three groups that do not divide the 64 tokens (one
    group then)."""
    jp, tp, jc, tc = _moe_params(n_groups=groups, capacity_factor=cf)
    x = normal(np.random.default_rng(1), (2, 32, D))
    jx, tx = both(x, dtype)
    with recorded_routing() as rec:
        got, gaux = tmoe.moe_ffn(tp, tx, tc)
        want, waux = jmoe.moe_ffn(jp, jx, jc)
    assert got.dtype == tx.dtype and gaux.dtype == torch.float32
    assert_close(got, want, MODULE_TOL[dtype], "moe_ffn")
    assert_close(gaux, waux, MODULE_TOL["float32"], "aux")
    assert assert_same_routing(rec, tc.top_k, "moe_ffn") > 0


def test_top_k_takes_the_lower_index_first_among_ties():
    """The per-expert top-C scores are mostly -1.0 ties: the port's order
    is ``jax.lax.top_k``'s."""
    rng = np.random.default_rng(2)
    x = np.where(rng.random((3, 5, 40)) < 0.7, -1.0,
                 rng.integers(0, 4, (3, 5, 40)) / 4.0).astype(np.float32)
    for k in (1, 8, 40):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = tmoe.top_k_lower_first(torch.as_tensor(x), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_the_combine_sums_experts_in_ascending_order():
    """In bf16 the combine is the reference's scatter-add order: each
    token's expert outputs added one at a time, experts ascending. The
    port's result equals that sum rebuilt from its own dispatch, to the
    bit, and a second call gives the same bits."""
    _, tp, _, tc = _moe_params(n_shared=0, capacity_factor=100.0)
    x = torch.as_tensor(normal(np.random.default_rng(3), (1, 16, D))).to(
        torch.bfloat16)
    y, _ = tmoe.moe_ffn(tp, x, tc)
    y2, _ = tmoe.moe_ffn(tp, x, tc)
    assert torch.equal(y, y2)
    xf = x.reshape(-1, D)
    _, top_i, gate = tmoe.route(tp, xf, tc)
    want = torch.zeros_like(xf)
    for t in range(xf.shape[0]):
        for e in sorted(top_i[t].tolist()):
            g, u = (xf[t:t + 1] @ tp["experts"]["wi"][e].to(x.dtype)).chunk(
                2, -1)
            h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
            ye = (h @ tp["experts"]["wo"][e].to(x.dtype)) * gate[t, e].to(
                x.dtype)
            want[t] = want[t] + ye[0]
    assert torch.equal(y.reshape(-1, D), want)


def test_init_moe_has_the_references_structure():
    ref = _np_tree(jmoe.init_moe(jax.random.PRNGKey(0), D, JMoE(**MOE)))
    port = tmoe.init_moe(torch.Generator().manual_seed(0), D, TMoE(**MOE))
    got = jax.tree.map(lambda t: t.numpy(), port)
    assert jax.tree.structure(got) == jax.tree.structure(ref)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        assert g.shape == w.shape


def test_expert_banks_are_drawn_as_weights():
    """``wi`` (E, d, 2f) and ``wo`` (E, f, d) scale by 1/sqrt(d_in) in both
    random draws, as a dense ``w`` does; SwiGLU's ``wi``/``wo`` hold a
    ``w`` and keep their draw."""
    ref = _np_tree(jmoe.init_moe(jax.random.PRNGKey(0), 1024,
                                 JMoE(**dict(MOE, d_ff_expert=256))))
    tree = randomize_tree(ref, 0)
    with torch.device("meta"):
        skel = tmoe.init_moe(torch.Generator(), 1024,
                             TMoE(**dict(MOE, d_ff_expert=256)))
    dev = random_params_like(skel, 0, device="cpu")
    for draw in (tree, jax.tree.map(lambda t: t.numpy(), dev)):
        assert abs(np.std(draw["experts"]["wi"]) * np.sqrt(1024) - 1) < 0.02
        assert abs(np.std(draw["experts"]["wo"]) * np.sqrt(256) - 1) < 0.02
        assert abs(np.std(draw["shared"]["wi"]["w"]) * np.sqrt(1024)
                   - 1) < 0.02


# ---------------------------------------------------------------------------
# the reference's MoE properties, on the port
# ---------------------------------------------------------------------------

def _x(seed, shape=(2, 16, D)):
    return torch.as_tensor(normal(np.random.default_rng(seed), shape))


def test_grouped_equals_ungrouped_at_high_capacity():
    tp, tc = _port()
    x = _x(1)
    y1, _ = tmoe.moe_ffn(tp, x, tc)
    y4, _ = tmoe.moe_ffn(tp, x, dataclasses.replace(tc, n_groups=4))
    np.testing.assert_allclose(to_np(y1), to_np(y4), atol=1e-5)


def test_capacity_saturation_matches_full():
    tp, tc = _port()
    x = _x(1)
    y1, _ = tmoe.moe_ffn(tp, x, tc)
    yf, _ = tmoe.moe_ffn(tp, x, dataclasses.replace(tc,
                                                    capacity_factor=100.0))
    np.testing.assert_allclose(to_np(y1), to_np(yf), atol=1e-5)


def test_expert_contribution_is_gated():
    """At capacity ~inf the output is the sum over the top-k experts of
    gate × expert (a dense loop)."""
    tp, tc = _port(3, capacity_factor=100.0, n_shared=0)
    x = _x(4, (1, 8, D))
    y, _ = tmoe.moe_ffn(tp, x, tc)
    xf = x.reshape(-1, D)
    probs = torch.softmax(xf @ tp["router"]["w"], -1)
    top_p, top_i = torch.topk(probs, tc.top_k)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    want = torch.zeros_like(xf)
    for e in range(tc.n_experts):
        g, u = (xf @ tp["experts"]["wi"][e]).chunk(2, -1)
        ye = (torch.nn.functional.silu(g) * u) @ tp["experts"]["wo"][e]
        gate = torch.where(top_i == e, top_p, 0.0).sum(-1)
        want = want + ye * gate[:, None]
    np.testing.assert_allclose(to_np(y.reshape(-1, D)), to_np(want),
                               atol=1e-4)


def test_aux_loss_balanced_vs_skewed():
    tp, tc = _port()
    _, aux_skew = tmoe.moe_ffn(tp, torch.ones((4, 32, D)), tc)
    _, aux_spread = tmoe.moe_ffn(tp, _x(5, (4, 32, D)), tc)
    assert float(aux_skew) > float(aux_spread)


@settings(max_examples=20, deadline=None)
@given(n=st.integers(1, 4096), e=st.integers(2, 64), k=st.integers(1, 4),
       cf=st.floats(0.5, 4.0))
def test_capacity_bounds(n, e, k, cf):
    kw = dict(n_experts=e, top_k=min(k, e), capacity_factor=cf,
              d_ff_expert=8)
    c = tmoe._capacity(n, TMoE(**kw))
    assert c == jmoe._capacity(n, JMoE(**kw))
    assert 1 <= c <= n
    assert c % 8 == 0 or c == n


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

MLA = dict(q_lora=64, kv_lora=32, rope_dim=16, nope_dim=32, v_dim=24)
MLA_H = 4


def _mla_params(seed=0):
    tree = randomize_tree(_np_tree(jmla.init_mla(
        jax.random.PRNGKey(seed), D, MLA_H, JMLA(**MLA))), seed + 1)
    return (jax.tree.map(jnp.asarray, tree),
            decoder_params_from_numpy(tree, device="cpu"))


@pytest.mark.parametrize("dtype", DT)
@pytest.mark.parametrize("kv_block", [4, 1024])
def test_mla_train_and_absorbed_decode_match_the_reference(kv_block, dtype):
    """The materialised prefill (q/k heads 48 wide, v heads 24) over one and
    several key blocks, then three absorbed decode steps against the
    padded latent cache, two batch rows at different lengths."""
    jp, tp = _mla_params()
    rng = np.random.default_rng(6)
    s, horizon = 12, 16
    x = normal(rng, (2, s, D))
    jx, tx = both(x, dtype)
    tol = MODULE_TOL[dtype]
    pos = np.arange(s)[None]
    got, gc = tmla.mla_attention_train(tp, tx, MLA_H, TMLA(**MLA),
                                       positions=torch.as_tensor(pos),
                                       kv_block=kv_block)
    want, wc = jmla.mla_attention_train(jp, jx, MLA_H, JMLA(**MLA),
                                        positions=jnp.asarray(pos),
                                        kv_block=kv_block)
    assert_close(got, want, tol, "mla_attention_train")
    for k in wc:
        assert_close(gc[k], wc[k], tol, f"prefill cache {k}")
    gc = {k: torch.nn.functional.pad(v, (0, 0, 0, horizon - s))
          for k, v in gc.items()}
    wc = {k: jnp.pad(v, ((0, 0), (0, horizon - s), (0, 0)))
          for k, v in wc.items()}
    lengths = np.array([s, s - 4], np.int32)
    for t in range(3):
        jn, tn = both(normal(rng, (2, 1, D)), dtype)
        got, gc = tmla.mla_attention_decode(tp, tn, gc,
                                            torch.as_tensor(lengths), MLA_H,
                                            TMLA(**MLA))
        want, wc = jmla.mla_attention_decode(jp, jn, wc, jnp.asarray(lengths),
                                             MLA_H, JMLA(**MLA))
        assert_close(got, want, tol, f"mla_attention_decode {t}")
        for k in wc:
            assert_close(gc[k], wc[k], tol, f"decode {t} cache {k}")
        lengths = lengths + 1


def test_mla_absorbed_decode_equals_the_materialised_form():
    """The last row of a prefill over S + 1 tokens equals one absorbed
    decode step after a prefill over S (fp32)."""
    _, tp = _mla_params(2)
    x = torch.as_tensor(normal(np.random.default_rng(7), (1, 9, D)))
    cfg = TMLA(**MLA)
    full, _ = tmla.mla_attention_train(tp, x, MLA_H, cfg,
                                       positions=torch.arange(9)[None])
    _, cache = tmla.mla_attention_train(tp, x[:, :8], MLA_H, cfg,
                                        positions=torch.arange(8)[None])
    cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 1))
             for k, v in cache.items()}
    step, _ = tmla.mla_attention_decode(tp, x[:, 8:], cache,
                                        torch.tensor([8]), MLA_H, cfg)
    np.testing.assert_allclose(to_np(step[:, 0]), to_np(full[:, 8]),
                               atol=1e-4)


def _draw_before_expert_banks(tree, seed):
    """``randomize_tree`` as it drew before the expert banks joined the
    weights: only a leaf named ``w`` scaled by 1/sqrt(d_in)."""
    rng = np.random.default_rng(seed)

    def walk(node, key):
        if isinstance(node, dict):
            return {k: walk(node[k], k) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return [walk(n, key) for n in node]
        z = rng.standard_normal(np.shape(node)).astype(np.float32)
        if key == "w":
            return z / np.float32(np.sqrt(np.shape(node)[-2]))
        if key == "gamma":
            return 1.0 + np.float32(0.1) * z
        return np.float32(0.1) * z

    return walk(tree, None)


@pytest.mark.parametrize("which", ["alphafold-smoke", "qwen2-1.5b",
                                   "gemma3-27b", "musicgen-medium"])
def test_existing_trees_draw_as_before(which):
    """The trees that predate the MoE kinds hold no array leaf named
    ``wi``/``wo``, so both random draws of them are unchanged."""
    from repro_torch.configs import SMOKE
    from repro_torch.configs import get_config as tget
    from repro_torch.exec import FastFold
    from repro_torch.layers.params import tree_leaves
    from repro_torch.models import decoder as tdec
    from repro_torch.weights import decoder_params_to_numpy, params_to_numpy

    if which == "alphafold-smoke":
        port = FastFold(SMOKE, device="cpu").init(0)
        tree = params_to_numpy(port)
    else:
        port = tdec.init_model(torch.Generator().manual_seed(0),
                               tget(which, reduced_variant=True))
        tree = decoder_params_to_numpy(port)
    new, old = randomize_tree(tree, 3), _draw_before_expert_banks(tree, 3)
    assert jax.tree.structure(new) == jax.tree.structure(old)
    for a, b in zip(jax.tree.leaves(new), jax.tree.leaves(old)):
        np.testing.assert_array_equal(a, b)

    def banks(node, key=None):
        if isinstance(node, dict):
            return [k for n in node for k in banks(node[n], n)]
        if isinstance(node, (list, tuple)):
            return [k for n in node for k in banks(n, key)]
        return [key] if key in ("wi", "wo") else []

    assert not banks(port)
    # random_params_like visits the same leaves with the same rule.
    again = random_params_like(port, 3, device="cpu")
    assert len(tree_leaves(again)) == len(tree_leaves(port))
