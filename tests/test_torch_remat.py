"""The ``dots`` remat policy of the port (``EvoformerConfig.remat_policy``,
``core.evoformer.evoformer_stack``), against the ``nothing`` policy and
against the reference's ``remat_policy="dots"`` (``jax.checkpoint`` with
``dots_saveable``): the same loss and gradients, the matrix products kept
from the forward instead of recomputed, and an unknown policy refused.

Tolerances: dots against nothing in the port, every gradient leaf within
1e-6 * max(1, max|g|) and the losses equal; the port's dots against the
reference's, the whole model's 1e-3 (torch_parity.FORWARD_TOL) on fully
randomised SMOKE weights, fp32, dropout off."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs.alphafold import SMOKE as J_SMOKE
from repro.core.alphafold import alphafold_train_loss as j_train_loss
from repro.core.alphafold import init_alphafold
from repro.exec.plan import preset, use_plan
from repro_torch.configs import SMOKE as T_SMOKE
from repro_torch.core import evoformer
from repro_torch.core.alphafold import (alphafold_train_loss,
                                        draw_dropout_keeps)
from repro_torch.data import protein_batches
from repro_torch.exec import FastFold
from repro_torch.layers.params import tree_leaves, tree_map
from repro_torch.weights import (params_from_numpy, params_to_numpy,
                                 randomize_tree)
from torch_parity import FORWARD_TOL, assert_close


def _dots(cfg):
    return dataclasses.replace(cfg, evoformer=dataclasses.replace(
        cfg.evoformer, remat_policy="dots"))


J_CFG = dataclasses.replace(J_SMOKE, compute_dtype=jnp.float32)
T_CFG = dataclasses.replace(T_SMOKE, compute_dtype=torch.float32)
PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
            torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)


@pytest.fixture(scope="module")
def tree():
    init = jax.jit(init_alphafold, static_argnums=1)
    return randomize_tree(
        jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), J_SMOKE)), 23)


@pytest.fixture(scope="module")
def batch():
    return next(protein_batches(batch=1, n_seq=6, n_res=12, seed=9)).as_dict()


def _port(tree, batch, cfg, keeps=None):
    params = tree_map(lambda t: t.requires_grad_(True),
                      params_from_numpy(tree, device="cpu"))
    ff = FastFold(cfg, device="cpu")
    loss, _ = alphafold_train_loss(params, ff.batch_to_device(batch), cfg,
                                   keeps=keeps, remat=True)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    return float(loss.detach()), grads, params


def test_dots_gives_the_same_gradients_as_nothing(tree, batch):
    keeps = draw_dropout_keeps(T_CFG, batch["msa"].shape,
                               torch.Generator().manual_seed(5))
    loss_n, grads_n, _ = _port(tree, batch, T_CFG, keeps)
    loss_d, grads_d, _ = _port(tree, batch, _dots(T_CFG), keeps)
    assert loss_d == loss_n
    assert len(grads_d) == len(grads_n)
    for d, n in zip(grads_d, grads_n):
        assert_close(d, n, 1e-6, "dots vs nothing")


def test_dots_matches_the_reference_dots(tree, batch):
    """The port's dots gradients against ``jax.grad`` of the reference's
    train loss under its own dots policy (dropout off)."""
    cfg = _dots(J_CFG)
    with use_plan(preset("default")):
        vg = jax.jit(jax.value_and_grad(
            lambda p, b: j_train_loss(p, b, cfg, rng=None), has_aux=True))
        (j_loss, _), j_grads = vg(jax.tree.map(jnp.asarray, tree),
                                  {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads, params = _port(tree, batch, _dots(T_CFG))
    assert abs(loss - float(j_loss)) <= 1e-4 * abs(float(j_loss))
    it = iter(grads)
    got = dict(jax.tree_util.tree_leaves_with_path(params_to_numpy(
        tree_map(lambda p: next(it), params))))
    want = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray,
                                                            j_grads))
    assert len(got) == len(want)
    for path, w in want:
        assert_close(got[path], w, FORWARD_TOL["float32"],
                     jax.tree_util.keystr(path))


class _CountProducts(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in PRODUCTS
        return func(*args, **(kwargs or {}))


def test_dots_keeps_the_forward_products():
    """Under dots the backward makes exactly the forward's matrix products
    fewer than under nothing: the recompute takes them from the forward,
    while everything else (on the card, every kernel) runs again."""
    g = torch.Generator().manual_seed(0)
    evo = dataclasses.replace(T_SMOKE.evoformer, n_blocks=2)
    params = evoformer.init_evoformer_stack(g, evo)
    b, s, r = 1, 5, 7
    msa = torch.randn(b, s, r, evo.d_msa, generator=g)
    pair = torch.randn(b, r, r, evo.d_pair, generator=g)
    masks = (torch.ones(b, s, r), torch.ones(b, r), torch.ones(b, r, r))
    with _CountProducts() as fwd:
        evoformer.evoformer_stack(params, msa, pair, *masks, cfg=evo)
    counts, grads = {}, {}
    for policy in ("nothing", "dots"):
        cfg = dataclasses.replace(evo, remat_policy=policy)
        live = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                        params)
        m, z = evoformer.evoformer_stack(live, msa, pair, *masks, cfg=cfg,
                                         remat=True)
        loss = m.sin().sum() + z.sin().sum()
        with _CountProducts() as bwd:
            grads[policy] = torch.autograd.grad(loss, tree_leaves(live))
        counts[policy] = bwd.n
    assert fwd.n > 0
    assert counts["nothing"] - counts["dots"] == fwd.n
    for d, n in zip(grads["dots"], grads["nothing"]):
        assert torch.equal(d, n)


def test_unknown_remat_policy_raises():
    evo = dataclasses.replace(T_SMOKE.evoformer, n_blocks=1,
                              remat_policy="everything")
    params = evoformer.init_evoformer_stack(torch.Generator(), evo)
    x = torch.zeros(1, 2, 3, evo.d_msa)
    z = torch.zeros(1, 3, 3, evo.d_pair)
    with pytest.raises(ValueError, match="remat_policy"):
        evoformer.evoformer_stack(params, x, z, torch.ones(1, 2, 3),
                                  torch.ones(1, 3), torch.ones(1, 3, 3),
                                  cfg=evo)
