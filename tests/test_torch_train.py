"""The port's training path against the JAX package: the SMOKE model's train
loss and the gradient of every parameter (fp32, fully randomised weights,
unpadded), with dropout off and with the reference's own dropout masks;
activation checkpointing on and off; the optimizers, the clip and the
schedule; three steps of ``make_train_step(FastFold(device="cpu")
.loss_fn)`` against the reference's ``make_train_step`` on its
``FastFold.loss_fn``, and two steps with gradient accumulation under AdamW
and LAMB. The reference runs under ``preset("default")``.

Tolerances: the loss and every metric within 1e-4 relative; every gradient
leaf within 1e-3 * max(1, max|g_jax|) (torch_parity.FORWARD_TOL, the whole
forward's bound: the gradient goes through the same two blocks and two
passes); the optimizer updates within 1e-6; the three losses within 1e-3
relative. The JAX functions are compiled once per module."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.alphafold import SMOKE as J_SMOKE
from repro.core.alphafold import alphafold_train_loss as j_train_loss
from repro.core.alphafold import init_alphafold
from repro.exec import FastFold as JFastFold
from repro.exec.plan import preset, use_plan
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro.train.loop import make_train_step as j_make_train_step
from repro_torch.configs import SMOKE as T_SMOKE
from repro_torch.core.alphafold import (alphafold_train_loss,
                                        draw_dropout_keeps)
from repro_torch.data import protein_batches
from repro_torch.exec import FastFold
from repro_torch.layers.params import tree_map
from repro_torch.optim import (adamw_init, adamw_update, clip_by_global_norm,
                               cosine_schedule, lamb_init, lamb_update,
                               linear_warmup)
from repro_torch.optim.optimizers import OptState
from repro_torch.train import make_train_step
from repro_torch.weights import (params_from_numpy, params_to_numpy,
                                 randomize_tree)
from torch_parity import FORWARD_TOL, assert_close, jax_dropout_keeps

J_CFG = dataclasses.replace(J_SMOKE, compute_dtype=jnp.float32)
T_CFG = dataclasses.replace(T_SMOKE, compute_dtype=torch.float32)
METRICS = ("loss", "fape", "aux_fape", "masked_msa", "distogram")
STEP_METRICS = METRICS + ("grad_norm", "lr", "nonfinite_skips")
DROPOUT_KEY = jax.random.PRNGKey(7)


@pytest.fixture(scope="module")
def tree():
    init = jax.jit(init_alphafold, static_argnums=1)
    return randomize_tree(
        jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), J_SMOKE)), 31)


@pytest.fixture(scope="module")
def batches():
    gen = protein_batches(batch=1, n_seq=6, n_res=12, seed=4)
    return [next(gen).as_dict() for _ in range(3)]


@pytest.fixture(scope="module")
def jax_value_and_grad():
    """jit(value_and_grad) of the reference's train loss, dropout off
    (rng None) and with its rng; compiled once for the module."""
    def loss(p, b, rng):
        return j_train_loss(p, b, J_CFG, rng=rng)

    with use_plan(preset("default")):
        off = jax.jit(jax.value_and_grad(lambda p, b: loss(p, b, None),
                                         has_aux=True))
        on = jax.jit(jax.value_and_grad(loss, has_aux=True))
    return {"off": lambda p, b: off(p, b),
            "reference-masks": lambda p, b: on(p, b, DROPOUT_KEY)}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _port_loss_and_grads(tree, batch, *, keeps=None, remat=True):
    params = tree_map(lambda t: t.requires_grad_(True),
                      params_from_numpy(tree, device="cpu"))
    ff = FastFold(T_CFG, device="cpu")
    loss, metrics = alphafold_train_loss(params, ff.batch_to_device(batch),
                                         T_CFG, keeps=keeps, remat=remat)
    loss.backward()
    return loss, metrics, tree_map(lambda t: t.grad, params)


def _hold_every_leaf(port_grads, jax_grads):
    got = dict(jax.tree_util.tree_leaves_with_path(params_to_numpy(port_grads)))
    want = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, jax_grads)))
    assert got.keys() == want.keys()
    for path, w in want.items():
        assert_close(got[path], w, FORWARD_TOL["float32"],
                     jax.tree_util.keystr(path))


@pytest.mark.parametrize("dropout", ["off", "reference-masks"])
def test_train_loss_and_grads_match_reference(dropout, tree, batches,
                                              jax_value_and_grad):
    batch = batches[0]
    (j_loss, j_metrics), j_grads = jax_value_and_grad[dropout](
        jax.tree.map(jnp.asarray, tree), _jb(batch))
    keeps = None
    if dropout == "reference-masks":
        keeps = jax_dropout_keeps(DROPOUT_KEY, J_CFG.evoformer,
                                  batch["msa"].shape)
    loss, metrics, grads = _port_loss_and_grads(tree, batch, keeps=keeps)
    assert set(metrics) == set(METRICS)
    for k in METRICS:
        want = float(j_metrics[k])
        assert abs(float(metrics[k].detach()) - want) <= 1e-4 * abs(want), k
    _hold_every_leaf(grads, j_grads)


def test_dropout_changes_the_loss(tree, batches, jax_value_and_grad):
    """The reference's masks matter: with them the loss moves away from the
    dropout-off loss, on both sides alike."""
    (off, _), _ = jax_value_and_grad["off"](jax.tree.map(jnp.asarray, tree),
                                            _jb(batches[0]))
    (on, _), _ = jax_value_and_grad["reference-masks"](
        jax.tree.map(jnp.asarray, tree), _jb(batches[0]))
    assert abs(float(on) - float(off)) > 1e-3 * abs(float(off))


def test_remat_gives_the_same_gradients(tree, batches):
    keeps = draw_dropout_keeps(T_CFG, batches[1]["msa"].shape,
                               torch.Generator().manual_seed(3))
    with_remat = _port_loss_and_grads(tree, batches[1], keeps=keeps,
                                      remat=True)
    without = _port_loss_and_grads(tree, batches[1], keeps=keeps, remat=False)
    assert float(with_remat[0].detach()) == float(without[0].detach())
    a = jax.tree_util.tree_leaves(params_to_numpy(with_remat[2]))
    b = jax.tree_util.tree_leaves(params_to_numpy(without[2]))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert_close(x, y, 1e-6, "remat vs no remat")


def test_draw_dropout_keeps_shapes_and_rates():
    """Six masks per block at the reduced shapes of the reference's shared
    axes, drawn from the explicit generator: the same seed gives the same
    masks, and the kept share is 1 - rate."""
    cfg = dataclasses.replace(T_CFG, evoformer=dataclasses.replace(
        T_CFG.evoformer, n_blocks=3))
    shape = (2, 64, 48)
    keeps = draw_dropout_keeps(cfg, shape, torch.Generator().manual_seed(1))
    again = draw_dropout_keeps(cfg, shape, torch.Generator().manual_seed(1))
    evo = cfg.evoformer
    want = {"msa_row": (2, 64, 1, evo.d_msa), "opm": (2, 1, 48, evo.d_pair),
            "tri_mult_out": (2, 1, 48, evo.d_pair),
            "tri_mult_in": (2, 1, 48, evo.d_pair),
            "tri_attn_start": (2, 1, 48, evo.d_pair),
            "tri_attn_end": (2, 48, 1, evo.d_pair)}
    assert len(keeps) == 3
    for blk, blk2 in zip(keeps, again):
        assert {k: tuple(v.shape) for k, v in blk.items()} == want
        for k, v in blk.items():
            assert v.dtype == torch.float32
            assert torch.equal(v, blk2[k])
            assert set(v.unique().tolist()) <= {0.0, 1.0}
            rate = evo.dropout_msa if k == "msa_row" else evo.dropout_pair
            assert abs(float(v.mean()) - (1 - rate)) < 0.05, k
    assert not torch.equal(keeps[0]["opm"], keeps[1]["opm"])


# ---------------------------------------------------------------------------
# Optimizers, clip, schedules
# ---------------------------------------------------------------------------

def _opt_trees(tree, seed):
    """Parameters, gradients and moments: numpy trees of the SMOKE shapes."""
    rng = np.random.default_rng(seed)
    rand = lambda scale: jax.tree.map(
        lambda x: (scale * rng.standard_normal(np.shape(x))).astype(np.float32),
        tree)
    m = rand(0.1)
    v = jax.tree.map(np.abs, rand(0.01))
    return tree, rand(1.0), m, v


@pytest.mark.parametrize("name", ["adamw", "lamb"])
def test_optimizer_update_matches_reference(name, tree):
    params, grads, m, v = _opt_trees(tree, 41)
    j_update = {"adamw": jopt.adamw_update, "lamb": jopt.lamb_update}[name]
    t_update = {"adamw": adamw_update, "lamb": lamb_update}[name]
    kw = {"weight_decay": 0.01}
    j_state = jopt.OptState(jnp.asarray(4, jnp.int32),
                            jax.tree.map(jnp.asarray, m),
                            jax.tree.map(jnp.asarray, v))
    j_p, j_s = j_update(jax.tree.map(jnp.asarray, params),
                        jax.tree.map(jnp.asarray, grads), j_state, 3e-3, **kw)
    cpu = lambda t: params_from_numpy(t, device="cpu")
    t_state = OptState(torch.tensor(4, dtype=torch.int32), cpu(m), cpu(v))
    t_p, t_s = t_update(cpu(params), cpu(grads), t_state, 3e-3, **kw)
    assert int(t_s.step) == int(j_s.step) == 5
    for got, want in ((t_p, j_p), (t_s.m, j_s.m), (t_s.v, j_s.v)):
        got = dict(jax.tree_util.tree_leaves_with_path(params_to_numpy(got)))
        for path, w in jax.tree_util.tree_leaves_with_path(
                jax.tree.map(np.asarray, want)):
            np.testing.assert_allclose(got[path], w, rtol=1e-6, atol=1e-6,
                                       err_msg=jax.tree_util.keystr(path))


def test_optimizer_init_is_fp32_zeros(tree):
    params = params_from_numpy(tree, dtype=torch.bfloat16, device="cpu")
    for init in (adamw_init, lamb_init):
        state = init(params)
        assert int(state.step) == 0
        for leaf in jax.tree_util.tree_leaves(params_to_numpy(state.m)):
            assert not leaf.any()
        assert state.m["msa_head"]["w"].dtype == torch.float32


@pytest.mark.parametrize("max_norm", [0.5, 1e6])
def test_clip_by_global_norm_matches_reference(max_norm, tree):
    _, grads, _, _ = _opt_trees(tree, 42)
    j_g, j_n = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, grads),
                                        max_norm)
    t_g, t_n = clip_by_global_norm(params_from_numpy(grads, device="cpu"), max_norm)
    np.testing.assert_allclose(float(t_n), float(j_n), rtol=1e-6)
    got = dict(jax.tree_util.tree_leaves_with_path(params_to_numpy(t_g)))
    for path, w in jax.tree_util.tree_leaves_with_path(
            jax.tree.map(np.asarray, j_g)):
        np.testing.assert_allclose(got[path], w, rtol=1e-6, atol=1e-7)


def test_schedules_match_reference():
    for step in (0, 1, 5, 99, 100, 101, 5000, 9999, 20000):
        np.testing.assert_allclose(
            float(cosine_schedule(step, 1e-3, 100, 10_000)),
            float(jsched.cosine_schedule(step, 1e-3, 100, 10_000)),
            rtol=1e-6)
        np.testing.assert_allclose(
            float(linear_warmup(step, 1e-3, 100)),
            float(jsched.linear_warmup(step, 1e-3, 100)), rtol=1e-6)


# ---------------------------------------------------------------------------
# The training loop
# ---------------------------------------------------------------------------

STEP_KW = dict(base_lr=1e-3, warmup_steps=2, total_steps=10)


def test_three_steps_track_the_reference(tree, batches):
    j_ff = JFastFold(J_CFG, preset("default"))
    j_init, j_step = j_make_train_step(j_ff.loss_fn, **STEP_KW)
    j_step = jax.jit(j_step)
    j_state = j_init(jax.tree.map(jnp.asarray, tree))
    ff = FastFold(T_CFG, device="cpu")
    init, step = make_train_step(ff.loss_fn, **STEP_KW)
    state = init(params_from_numpy(tree, device="cpu"))
    for batch in batches:
        j_state, j_metrics = j_step(j_state, _jb(batch), None)
        state, metrics = step(state, batch)
        assert set(metrics) == set(STEP_METRICS)
        for k in ("loss", "grad_norm", "lr"):
            want = float(j_metrics[k])
            assert abs(float(metrics[k]) - want) <= 1e-3 * abs(want), k
        assert float(metrics["nonfinite_skips"]) == 0.0
    assert int(state.step) == 3 and int(state.opt_state.step) == 3


@pytest.mark.parametrize("accum_steps,guard", [(1, False), (2, True)])
def test_metric_keys_always_present(accum_steps, guard, tree):
    """Every step reports the fixed keys, with gradient accumulation over
    two micro-batches (and dropout drawn from a generator) and with the
    guard off."""
    ff = FastFold(T_CFG, device="cpu")
    init, step = make_train_step(ff.loss_fn, accum_steps=accum_steps,
                                 guard_nonfinite=guard, **STEP_KW)
    batch = next(protein_batches(batch=2, n_seq=4, n_res=8, seed=5)).as_dict()
    state, metrics = step(init(params_from_numpy(tree, device="cpu")), batch,
                          torch.Generator().manual_seed(0))
    assert {"loss", "grad_norm", "lr", "nonfinite_skips"} <= set(metrics)
    assert float(metrics["nonfinite_skips"]) == 0.0
    assert all(torch.isfinite(v) for v in metrics.values())


@pytest.mark.parametrize("optimizer", ["adamw", "lamb"])
def test_gradient_accumulation_tracks_the_reference(optimizer, tree):
    """Two steps of ``accum_steps=2`` (two micro-batches of one) with weight
    decay, against the reference's ``make_train_step`` on the same batches:
    loss, grad_norm and lr within the three-step test's 1e-3. Only dropout
    off can be held: with dropout the port draws each micro-batch's masks
    in turn from one generator, while the reference folds the micro-batch
    index into its key (``src/repro/train/loop.py:81``)."""
    kw = dict(STEP_KW, optimizer=optimizer, accum_steps=2, weight_decay=0.01)
    j_init, j_step = j_make_train_step(
        JFastFold(J_CFG, preset("default")).loss_fn, **kw)
    j_step = jax.jit(j_step)
    j_state = j_init(jax.tree.map(jnp.asarray, tree))
    init, step = make_train_step(FastFold(T_CFG, device="cpu").loss_fn, **kw)
    state = init(params_from_numpy(tree, device="cpu"))
    gen = protein_batches(batch=2, n_seq=6, n_res=12, seed=6)
    for _ in range(2):
        batch = next(gen).as_dict()
        j_state, j_metrics = j_step(j_state, _jb(batch), None)
        state, metrics = step(state, batch)
        for k in ("loss", "grad_norm", "lr"):
            want = float(j_metrics[k])
            assert abs(float(metrics[k]) - want) <= 1e-3 * abs(want), k
        assert float(metrics["nonfinite_skips"]) == 0.0
    assert int(state.step) == 2 and int(state.opt_state.step) == 2


def test_nonfinite_gradient_is_skipped():
    """A NaN gradient leaves the parameters and the optimizer state as they
    were, still advances the step, and reports nonfinite_skips = 1."""
    params = {"w": torch.ones(3), "blocks": [{"b": torch.zeros(2)}]}

    def loss_fn(p, batch, rng):
        loss = (p["w"] * batch["x"]).sum() + p["blocks"][0]["b"].sum()
        return loss, {"loss": loss}

    init, step = make_train_step(loss_fn, base_lr=0.1, warmup_steps=1)
    state, metrics = step(init(params), {"x": torch.ones(3)})
    assert float(metrics["nonfinite_skips"]) == 0.0
    good = state
    state, metrics = step(good, {"x": torch.tensor([1.0, float("nan"), 1.0])})
    assert float(metrics["nonfinite_skips"]) == 1.0
    assert not torch.isfinite(metrics["grad_norm"])
    assert torch.equal(state.params["w"], good.params["w"])
    assert torch.equal(state.opt_state.m["w"], good.opt_state.m["w"])
    assert int(state.opt_state.step) == int(good.opt_state.step) == 1
    assert int(state.step) == 2
