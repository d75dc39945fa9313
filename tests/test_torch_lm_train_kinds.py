"""Decoder LM training in the port against the JAX package, the MoE, MLA,
Mamba-hybrid and xLSTM kinds: ``lm_loss`` and every gradient leaf of the
reduced deepseek-moe-16b, deepseek-v2-236b, hymba-1.5b and xlstm-125m on
the same fully randomised weights and batch, fp32 (1e-3·max(1, max|jax|))
and bf16 (2e-2), MoE routing held in bf16 by the rule of
``torch_parity.assert_same_routing``; then each kind's module gradients
against ``jax.grad`` of the reference's at the module tolerance
(1e-4·max(1, max|jax|) fp32): the MoE FFN with binding capacity (routing
and the per-expert top-C not differentiated, the gates, expert banks and
``aux``'s ``mean_p`` term are), MLA's materialised attention (values
narrower than the queries), the Mamba block (the port's sequential scan
against the reference's differentiated ``associative_scan``), mLSTM and
sLSTM, also with saturated gates where the stabilisers start at -1e30 and
``log_d`` holds -inf (no ``0·inf`` NaN). The per-layer checkpoint changes
no bit, the reference's smoke train step runs on the port, and R8 holds
in training."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs.base import MLAConfig as JMLA
from repro.configs.base import MoEConfig as JMoE
from repro.configs.base import SSMConfig as JSSM
from repro.models import decoder as jdec
from repro.models import mla as jmla
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro.models import xlstm as jx
from repro_torch.configs import get_config as tget
from repro_torch.configs.base import MLAConfig as TMLA
from repro_torch.configs.base import MoEConfig as TMoE
from repro_torch.configs.base import SSMConfig as TSSM
from repro_torch.layers.params import tree_map
from repro_torch.models import decoder as tdec
from repro_torch.models import mla as tmla
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from repro_torch.models import xlstm as tx
from repro_torch.weights import (decoder_params_from_numpy,
                                 decoder_params_to_numpy, randomize_tree)
from torch_parity import (FORWARD_TOL, MODULE_TOL, assert_close,
                          assert_lm_loss_close, assert_remat_changes_no_bit,
                          assert_same_routing,
                          assert_smoke_forward_and_train_step, both,
                          decoder_weights, lm_batch_both, lm_loss_both,
                          normal, np_tree, recorded_routing,
                          one_torch_thread)  # noqa: F401

DT = ["float32", "bfloat16"]
KINDS = ["deepseek-moe-16b", "deepseek-v2-236b", "hymba-1.5b", "xlstm-125m"]
TOL = {"float32": FORWARD_TOL["float32"], "bfloat16": MODULE_TOL["bfloat16"]}
# 32 tokens: past hymba's reduced window (16), within one mLSTM chunk.
B, S = 2, 32


@pytest.mark.parametrize("dtype", DT)
@pytest.mark.parametrize("arch", KINDS)
def test_lm_loss_and_grads_match_the_reference(arch, dtype):
    """An MoE arch in bf16 first holds its routing on the same forward
    (no graph): each router call chooses the same top-k experts in both
    packages for every token whose margin exceeds bf16's resolution."""
    jc, tc = jget(arch, reduced_variant=True), tget(arch, reduced_variant=True)
    jp, tp = decoder_weights(jdec, jc, 0)
    jb, tb = lm_batch_both(jc, B, S, seed=3)
    if tc.moe and dtype == "bfloat16":
        with recorded_routing() as rec, torch.no_grad():
            tdec.model_forward(tp, tb["tokens"], tc)
            jdec.model_forward(jp, jb["tokens"], jc, remat=False)
        assert assert_same_routing(rec, tc.moe.top_k, arch) > 0
    port, ref = lm_loss_both(jdec, tdec, jc, tc, jp, tp, jb, tb, dtype)
    assert_lm_loss_close(port, ref, TOL[dtype], f"{arch} {dtype}")
    if tc.moe:
        assert float(port[1]["aux"]) > 0.0


@pytest.mark.parametrize("arch", KINDS)
def test_remat_changes_no_bit(arch):
    assert_remat_changes_no_bit(jdec, tdec, arch)


@pytest.mark.parametrize("arch", KINDS)
def test_smoke_forward_and_train_step(arch):
    assert_smoke_forward_and_train_step(tdec, arch)


def test_training_keeps_r8():
    """ROADMAP.md R8 in training: 300 tokens are not a multiple of
    mLSTM's 256-token chunk; the reference asserts, the port raises
    before any gradient."""
    jc = jget("xlstm-125m", reduced_variant=True)
    tc = tget("xlstm-125m", reduced_variant=True)
    jp, tp = decoder_weights(jdec, jc, 4)
    jb, tb = lm_batch_both(jc, 1, 300, seed=6)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tdec.lm_loss(tree_map(lambda t: t.requires_grad_(True), tp), tb, tc)
    with pytest.raises(AssertionError):
        jdec.lm_loss(jp, jb, jc)


# ---------------------------------------------------------------------------
# module gradients
# ---------------------------------------------------------------------------

def _pair(init_tree, seed):
    """(reference tree, port tree) of one randomised draw."""
    tree = randomize_tree(np_tree(init_tree), seed)
    return (jax.tree.map(jnp.asarray, tree),
            decoder_params_from_numpy(tree, device="cpu"))


def _vjp_both(fn_t, fn_j, tp, jp, x, dtype, seed, aux_weight=None):
    """Gradients of ``<out, cot> (+ aux_weight · aux)`` in both packages
    with respect to the parameters and the input: (port's as the
    reference's numpy tree, dx), (reference's, dx)."""
    jx_, tx_ = both(x, dtype)
    live = tree_map(lambda t: t.detach().requires_grad_(True), tp)
    tx_.requires_grad_(True)
    out_t = fn_t(live, tx_)
    y_t = out_t[0] if isinstance(out_t, tuple) else out_t
    cot = normal(np.random.default_rng(seed), tuple(y_t.shape))
    jc_, tc_ = both(cot, dtype)
    obj = (y_t.float() * tc_.float()).sum()
    if aux_weight is not None:
        obj = obj + aux_weight * out_t[1]
    obj.backward()
    tg = decoder_params_to_numpy(tree_map(
        lambda t: torch.zeros_like(t) if t.grad is None else t.grad, live))

    def objective(p, xx):
        out = fn_j(p, xx)
        y = out[0] if isinstance(out, tuple) else out
        o = jnp.sum(y.astype(jnp.float32) * jc_.astype(jnp.float32))
        return o + aux_weight * out[1] if aux_weight is not None else o

    jg, jdx = jax.jit(jax.grad(objective, argnums=(0, 1)))(jp, jx_)
    return (tg, tx_.grad), (np_tree(jg), jdx)


def _assert_grads(port, ref, tol, what):
    (tg, tdx), (jg, jdx) = port, ref
    assert_close(tdx, jdx, tol, f"{what} dx")
    got = jax.tree_util.tree_flatten_with_path(tg)[0]
    want = jax.tree.leaves(jg)
    assert len(got) == len(want)
    for (path, g), w in zip(got, want):
        assert_close(g, w, tol, f"{what} d{jax.tree_util.keystr(path)}")


MOE = dict(n_experts=4, top_k=2, n_shared=1, d_ff_expert=32)


@pytest.mark.parametrize("groups,cf", [(1, 1.0), (4, 1.0), (1, 100.0)])
def test_moe_ffn_grads(groups, cf):
    """Capacity binding (cf 1.0: dropped tokens, whose rows add zeros in
    the combine's scatter) and not, one group and four; the aux loss
    weighted in, fp32. Selected tokens the expert was not routed to have
    gate 0 and pass no gradient to the router, as in the reference."""
    cfg = dict(MOE, n_groups=groups, capacity_factor=cf)
    jp, tp = _pair(jmoe.init_moe(jax.random.PRNGKey(0), 64, JMoE(**cfg)), 1)
    x = normal(np.random.default_rng(2), (2, 32, 64))
    port, ref = _vjp_both(lambda p, xx: tmoe.moe_ffn(p, xx, TMoE(**cfg)),
                          lambda p, xx: jmoe.moe_ffn(p, xx, JMoE(**cfg)),
                          tp, jp, x, "float32", seed=3, aux_weight=3.0)
    _assert_grads(port, ref, MODULE_TOL["float32"], f"moe g{groups} cf{cf}")
    assert np.abs(port[0]["router"]["w"]).max() > 0


MLA = dict(q_lora=32, kv_lora=24, rope_dim=8, nope_dim=16, v_dim=12)


@pytest.mark.parametrize("kv_block", [4, 1024])
def test_mla_attention_grads(kv_block):
    """The materialised form, q/k heads 24 wide and v heads 12, over
    several key blocks and one, fp32."""
    jp, tp = _pair(jmla.init_mla(jax.random.PRNGKey(4), 64, 4, JMLA(**MLA)),
                   5)
    pos = np.arange(12)[None]
    x = normal(np.random.default_rng(6), (2, 12, 64))
    port, ref = _vjp_both(
        lambda p, xx: tmla.mla_attention_train(
            p, xx, 4, TMLA(**MLA), positions=torch.as_tensor(pos),
            kv_block=kv_block),
        lambda p, xx: jmla.mla_attention_train(
            p, xx, 4, JMLA(**MLA), positions=jnp.asarray(pos),
            kv_block=kv_block),
        tp, jp, x, "float32", seed=7)
    _assert_grads(port, ref, MODULE_TOL["float32"], "mla")


SSM_KW = dict(state_dim=8, expand=2, conv_width=4)


@pytest.mark.parametrize("dtype", DT)
def test_mamba_grads(dtype):
    """The port's sequential scan (kept: a prefill and decode agree in
    the state to the bit) against the reference's differentiated
    ``associative_scan``, 24 steps."""
    jp, tp = _pair(jssm.init_mamba(jax.random.PRNGKey(3), 32,
                                   JSSM(**SSM_KW)), 4)
    x = normal(np.random.default_rng(0), (2, 24, 32), 0.5)
    port, ref = _vjp_both(
        lambda p, xx: tssm.mamba_forward(p, xx, TSSM(**SSM_KW)),
        lambda p, xx: jssm.mamba_forward(p, xx, JSSM(**SSM_KW)),
        tp, jp, x, dtype, seed=1)
    _assert_grads(port, ref, MODULE_TOL[dtype], f"mamba {dtype}")


def test_mamba_scan_writes_nothing_in_place():
    """The states are stacked once: no ``CopySlices`` node (an in-place
    write into the whole state tensor) in the forward's graph."""
    _, tp = _pair(jssm.init_mamba(jax.random.PRNGKey(3), 32,
                                  JSSM(**SSM_KW)), 4)
    x = torch.as_tensor(normal(np.random.default_rng(0), (1, 12, 32)))
    y, _ = tssm.mamba_forward(tree_map(lambda t: t.requires_grad_(True), tp),
                              x, TSSM(**SSM_KW))
    seen, todo, names = set(), [y.grad_fn], set()
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(type(fn).__name__)
        todo.extend(f for f, _ in fn.next_functions)
    assert "CopySlices" not in names and "StackBackward0" in names


@pytest.mark.parametrize("dtype", DT)
@pytest.mark.parametrize("scale,chunk", [(0.5, 8), (0.5, 256), (30.0, 8)])
def test_mlstm_grads(scale, chunk, dtype):
    """Chunks of 8 (the state carried across three) and one chunk; at
    input scale 30 the gates saturate, where ``log_d``'s -inf off the
    causal triangle and the -1e30 stabiliser must give no NaN."""
    jp, tp = _pair(jx.init_mlstm(jax.random.PRNGKey(1), 32, 4), 5)
    x = normal(np.random.default_rng(1), (2, 24, 32), scale)
    port, ref = _vjp_both(
        lambda p, xx: tx.mlstm_forward(p, xx, 4, chunk=chunk),
        lambda p, xx: jx.mlstm_forward(p, xx, 4, chunk=chunk),
        tp, jp, x, dtype, seed=2)
    _assert_grads(port, ref, MODULE_TOL[dtype], f"mlstm {dtype}")


@pytest.mark.parametrize("dtype", DT)
@pytest.mark.parametrize("scale", [0.5, 30.0])
def test_slstm_grads(scale, dtype):
    """The time scan's gradients; at input scale 30 the exponential gates
    saturate against the -1e30 stabiliser."""
    jp, tp = _pair(jx.init_slstm(jax.random.PRNGKey(2), 32, 4), 6)
    x = normal(np.random.default_rng(3), (2, 16, 32), scale)
    port, ref = _vjp_both(tx.slstm_forward, jx.slstm_forward, tp, jp, x,
                          dtype, seed=4)
    _assert_grads(port, ref, MODULE_TOL[dtype], f"slstm {dtype}")
