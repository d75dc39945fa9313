"""The whole port under the plans that select the materialized branches,
against the JAX package under the same plans: the SMOKE forward served
through ``FastFold(plan=...)`` and the train loss with the gradient of
every parameter, under ``preset("oracle")``, ``preset("triangle-oracle")``
and ``KernelPolicy(attention="oracle")``; fp32, fully randomised weights,
within 1e-3 * max(1, max|jax|) (torch_parity.FORWARD_TOL).

Also: the plan reaches a backward that runs on another thread, outside the
``use_plan`` scope (the checkpointed blocks' recompute takes the forward's
branches), and a padded training batch, whose loss no longer lands on
padding residues, against the reference and against autograd of the port's
plain attention forward."""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.alphafold import SMOKE as J_SMOKE
from repro.core.alphafold import alphafold_forward, init_alphafold
from repro.core.alphafold import alphafold_train_loss as j_train_loss
from repro.data import protein_batches as j_protein_batches
from repro.exec import plan as jplan
from repro_torch.configs import SMOKE as T_SMOKE
from repro_torch.data import protein_batches
from repro_torch.exec import FastFold
from repro_torch.exec import plan as tplan
from repro_torch.kernels import ops
from repro_torch.layers.params import tree_leaves, tree_map
from repro_torch.weights import params_from_numpy, randomize_tree
from test_torch_train import _hold_every_leaf
from torch_parity import FORWARD_TOL, assert_close

J_CFG = dataclasses.replace(J_SMOKE, compute_dtype=jnp.float32)
T_CFG = dataclasses.replace(T_SMOKE, compute_dtype=torch.float32)
OUTPUTS = ("coords", "msa_logits", "distogram_logits", "msa", "pair")
PLANS = {
    "oracle": dict(enabled=False),
    "triangle-oracle": dict(triangle="oracle", opm="oracle"),
    "attention-oracle": dict(attention="oracle"),
}


def _plans(name):
    return (jplan.ExecutionPlan(kernels=jplan.KernelPolicy(**PLANS[name])),
            tplan.ExecutionPlan(kernels=tplan.KernelPolicy(**PLANS[name])))


@pytest.fixture(scope="module")
def tree():
    init = jax.jit(init_alphafold, static_argnums=1)
    return randomize_tree(
        jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), J_SMOKE)), 51)


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _port_grads(tree, batch, plan, *, backward=None):
    """The port's train loss and every gradient under ``plan``;
    ``backward(loss)`` runs the backward (default: here, in the scope)."""
    params = tree_map(lambda t: t.requires_grad_(True),
                      params_from_numpy(tree, device="cpu"))
    ff = FastFold(T_CFG, device="cpu", plan=plan)
    loss, metrics = ff.train_loss(params, batch)
    (backward or (lambda l: l.backward()))(loss)
    return loss, metrics, tree_map(lambda t: t.grad, params)


@pytest.mark.parametrize("name", list(PLANS))
def test_forward_under_plan_matches_reference(name, tree):
    jp, tp = _plans(name)
    requests = [
        next(protein_batches(batch=1, n_seq=6, n_res=12, seed=1)).as_dict(),
        next(protein_batches(batch=2, n_seq=5, n_res=12, seed=2,
                             n_real=8)).as_dict(),
    ]
    ff = FastFold(T_CFG, device="cpu", plan=tp)
    outs = ff.serve(params_from_numpy(tree, device="cpu"), requests)
    j_params = jax.tree.map(jnp.asarray, tree)
    with jplan.use_plan(jp):
        j_forward = jax.jit(lambda p, b: alphafold_forward(p, b, J_CFG))
        for req, got in zip(requests, outs):
            want = j_forward(j_params, _jb(req))
            for k in OUTPUTS:
                assert_close(got[k], want[k], FORWARD_TOL["float32"],
                             f"{name} {k}")


@pytest.mark.parametrize("name", list(PLANS))
def test_train_grads_under_plan_match_reference(name, tree):
    jp, tp = _plans(name)
    batch = next(protein_batches(batch=1, n_seq=6, n_res=12, seed=4)).as_dict()
    with jplan.use_plan(jp):
        (j_loss, _), j_grads = jax.jit(jax.value_and_grad(
            lambda p, b: j_train_loss(p, b, J_CFG), has_aux=True))(
                jax.tree.map(jnp.asarray, tree), _jb(batch))
    loss, _, grads = _port_grads(tree, batch, tp)
    assert abs(float(loss.detach()) - float(j_loss)) <= 1e-4 * abs(float(j_loss))
    _hold_every_leaf(grads, j_grads)


def test_plan_reaches_a_backward_outside_its_scope(tree, monkeypatch):
    """The loss is built under attention-oracle; its backward runs on a new
    thread, which sees no ``use_plan`` scope (its current plan is the
    default). The checkpointed blocks' recompute must take the materialized
    attention again (4 sites x 2 blocks), never the fused one, and give the
    gradients of a backward run inside the scope."""
    _, tp = _plans("attention-oracle")
    batch = next(protein_batches(batch=1, n_seq=6, n_res=12, seed=6)).as_dict()
    _, _, want = _port_grads(tree, batch, tp)
    calls, seen_plans = [], []
    for name in ("fused_softmax", "fused_attention"):
        real = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _r=real, _n=name, **k: (
            calls.append(_n), _r(*a, **k))[1])

    def on_thread(loss):
        def run():
            seen_plans.append(tplan.current_plan())
            calls.clear()
            loss.backward()
        t = threading.Thread(target=run)
        t.start()
        t.join()

    loss, _, got = _port_grads(tree, batch, tp, backward=on_thread)
    assert seen_plans == [tplan.preset("default")]
    assert calls == ["fused_softmax"] * 4 * T_CFG.evoformer.n_blocks
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        assert_close(g, w, 1e-6, "in the scope vs outside it")


def test_padded_batch_puts_no_loss_on_padding():
    """``n_real`` zeroes bert_mask with the other masks past the real
    residues, and draws exactly what the reference's generator draws."""
    kw = dict(batch=2, n_seq=5, n_res=12, seed=8)
    pad = next(protein_batches(n_real=8, **kw))
    ref = next(j_protein_batches(**kw))
    for k in ("msa_mask", "bert_mask"):
        assert not getattr(pad, k)[..., 8:].any(), k
        np.testing.assert_array_equal(getattr(pad, k)[..., :8],
                                      getattr(ref, k)[..., :8])
    assert not pad.seq_mask[:, 8:].any()
    for k in ("msa", "residue_index", "aatype", "pseudo_beta", "true_msa"):
        assert getattr(pad, k).tobytes() == getattr(ref, k).tobytes(), k


def test_padded_batch_grads_match_reference_and_autograd(tree):
    """A batch padded from 8 to 12 residues: the port's loss and every
    gradient against the reference's, and against the port with the
    attention materialized, whose backward is autograd of the plain
    forward (no flash backward of fully masked rows, R4)."""
    batch = next(protein_batches(batch=1, n_seq=6, n_res=12, seed=4,
                                 n_real=8)).as_dict()
    with jplan.use_plan(jplan.preset("default")):
        (j_loss, _), j_grads = jax.jit(jax.value_and_grad(
            lambda p, b: j_train_loss(p, b, J_CFG), has_aux=True))(
                jax.tree.map(jnp.asarray, tree), _jb(batch))
    loss, _, grads = _port_grads(tree, batch, tplan.preset("default"))
    assert abs(float(loss.detach()) - float(j_loss)) <= 1e-4 * abs(float(j_loss))
    _hold_every_leaf(grads, j_grads)
    _, tp = _plans("attention-oracle")
    _, _, plain = _port_grads(tree, batch, tp)
    for g, w in zip(tree_leaves(grads), tree_leaves(plain)):
        assert_close(g, w, FORWARD_TOL["float32"], "vs autograd")
