"""The port's layers and AlphaFold modules against the JAX package on the
same fully randomised weights (no zero-initialised projection left) and the
same seeded inputs, at SMOKE widths, in fp32 and bf16. The reference runs
under ``preset("default")``, whose fused triangle and OPM branch is the one
the port takes, and the fused sites and one block also under
``preset("interpret")``, the reference's Pallas kernels in interpret mode.
Tolerances: see torch_parity."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.alphafold import SMOKE as J_SMOKE
from repro.core import alphafold as jaf
from repro.core import evoformer as jevo
from repro.core import structure as jst
from repro.core.dist import LocalDist
from repro.exec.plan import preset, use_plan
from repro.layers import attention as jattn
from repro.layers import mlp as jmlp
from repro.layers.norms import init_layer_norm
from repro.layers.params import init_dense
from repro_torch.configs import SMOKE as T_SMOKE
from repro_torch.core import alphafold as taf
from repro_torch.core import evoformer as tevo
from repro_torch.core import structure as tst
from repro_torch.layers import attention as tattn
from repro_torch.layers import mlp as tmlp
from repro_torch.weights import params_from_numpy, randomize_tree
from torch_parity import (MODULE_TOL, assert_close, both, jax_dropout_keeps,
                          normal)

DT = ["float32", "bfloat16"]
B, S, R = 2, 6, 12
N_REAL = 9        # residues 9.. are padding: masks zeroed there
J_EVO, T_EVO = J_SMOKE.evoformer, T_SMOKE.evoformer


def _pair_of_trees(tree):
    """The same numpy tree as JAX arrays and as the port's tensors."""
    return (jax.tree.map(jnp.asarray, tree),
            params_from_numpy({"x": tree}, device="cpu")["x"])


@pytest.fixture(scope="module")
def block_params():
    init = jax.jit(jevo.init_evoformer_block, static_argnums=1)
    tree = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), J_EVO))
    return _pair_of_trees(randomize_tree(tree, 11))


@pytest.fixture(scope="module")
def feats():
    rng = np.random.default_rng(5)
    seq = np.ones((B, R), np.float32)
    seq[:, N_REAL:] = 0
    msa_mask = np.ones((B, S, R), np.float32)
    msa_mask[..., N_REAL:] = 0
    msa_mask[1, 2] = 0                    # one whole MSA row masked
    return {"msa": normal(rng, (B, S, R, J_EVO.d_msa)),
            "pair": normal(rng, (B, R, R, J_EVO.d_pair)),
            "seq_mask": seq, "msa_mask": msa_mask,
            "pair_mask": seq[:, :, None] * seq[:, None, :]}


def _masks(f):
    return ({k: jnp.asarray(f[k]) for k in ("seq_mask", "msa_mask", "pair_mask")},
            {k: torch.as_tensor(f[k]) for k in ("seq_mask", "msa_mask", "pair_mask")})


SITES = ["msa_row", "msa_col", "msa_trans", "opm", "tri_mult_out",
         "tri_mult_in", "tri_attn_start", "tri_attn_end", "pair_trans"]


def _run_site(site, p, msa, pair, m, cfg, jax_side):
    d = LocalDist()
    if jax_side:
        e = jevo
        return {
            "msa_row": lambda: e.msa_row_attention(p["msa_row"], msa, pair, m["seq_mask"], d, cfg),
            "msa_col": lambda: e.msa_col_attention(p["msa_col"], msa, m["msa_mask"], d, cfg),
            "msa_trans": lambda: e.msa_transition(p["msa_trans"], msa),
            "opm": lambda: e.outer_product_mean(p["opm"], msa, m["msa_mask"], d, cfg),
            "tri_mult_out": lambda: e.triangle_mult_outgoing(p["tri_mult_out"], pair, m["pair_mask"], d, cfg),
            "tri_mult_in": lambda: e.triangle_mult_incoming(
                p["tri_mult_in"], pair, e.transpose_pair(pair, d),
                e.transpose_pair(m["pair_mask"][..., None], d)[..., 0], d, cfg),
            "tri_attn_start": lambda: e.triangle_attention(p["tri_attn_start"], pair, m["seq_mask"], d, cfg),
            "tri_attn_end": lambda: e.transpose_pair(e.triangle_attention(
                p["tri_attn_end"], e.transpose_pair(pair, d), m["seq_mask"], d, cfg), d),
            "pair_trans": lambda: jmlp.transition(p["pair_trans"]["mlp"], jevo.layer_norm(p["pair_trans"]["ln"], pair)),
        }[site]()
    e = tevo
    return {
        "msa_row": lambda: e.msa_row_attention(p["msa_row"], msa, pair, m["seq_mask"], cfg),
        "msa_col": lambda: e.msa_col_attention(p["msa_col"], msa, m["msa_mask"], cfg),
        "msa_trans": lambda: e.msa_transition(p["msa_trans"], msa),
        "opm": lambda: e.outer_product_mean(p["opm"], msa, m["msa_mask"], cfg),
        "tri_mult_out": lambda: e.triangle_mult_outgoing(p["tri_mult_out"], pair, m["pair_mask"]),
        "tri_mult_in": lambda: e.triangle_mult_incoming(
            p["tri_mult_in"], e.transpose_pair(pair), e.transpose_pair(m["pair_mask"])),
        "tri_attn_start": lambda: e.triangle_attention(p["tri_attn_start"], pair, m["seq_mask"], cfg),
        "tri_attn_end": lambda: e.transpose_pair(e.triangle_attention(
            p["tri_attn_end"], e.transpose_pair(pair), m["seq_mask"], cfg)),
        "pair_trans": lambda: tmlp.transition(p["pair_trans"]["mlp"], e.layer_norm(p["pair_trans"]["ln"], pair)),
    }[site]()


@pytest.mark.parametrize("dtype", DT)
@pytest.mark.parametrize("site", SITES)
def test_evoformer_submodule(site, dtype, block_params, feats):
    jp, tp = block_params
    msa_j, msa_t = both(feats["msa"], dtype)
    pair_j, pair_t = both(feats["pair"], dtype)
    mj, mt = _masks(feats)
    with use_plan(preset("default")):
        want = _run_site(site, jp, msa_j, pair_j, mj, J_EVO, True)
    got = _run_site(site, tp, msa_t, pair_t, mt, T_EVO, False)
    assert got.dtype == msa_t.dtype
    assert_close(got, want, MODULE_TOL[dtype], site)


@pytest.mark.parametrize("dtype", DT)
@pytest.mark.parametrize("site", ["opm", "tri_mult_out", "tri_mult_in"])
def test_fused_site_vs_interpret(site, dtype, block_params, feats):
    """The three sites the fused triangle and OPM kernels serve, against the
    reference's Pallas kernels in interpret mode."""
    jp, tp = block_params
    msa_j, msa_t = both(feats["msa"], dtype)
    pair_j, pair_t = both(feats["pair"], dtype)
    mj, mt = _masks(feats)
    with use_plan(preset("interpret")):
        want = _run_site(site, jp, msa_j, pair_j, mj, J_EVO, True)
    got = _run_site(site, tp, msa_t, pair_t, mt, T_EVO, False)
    assert_close(got, want, MODULE_TOL[dtype], site)


def _blocks(dtype, block_params, feats, plan):
    jp, tp = block_params
    msa_j, msa_t = both(feats["msa"], dtype)
    pair_j, pair_t = both(feats["pair"], dtype)
    mj, mt = _masks(feats)
    with use_plan(preset(plan)):
        want = jevo.evoformer_block(jp, msa_j, pair_j, mj["msa_mask"],
                                    mj["seq_mask"], mj["pair_mask"],
                                    dist=LocalDist(), cfg=J_EVO)
    got = tevo.evoformer_block(tp, msa_t, pair_t, mt["msa_mask"],
                               mt["seq_mask"], mt["pair_mask"], cfg=T_EVO)
    return got, want


@pytest.mark.parametrize("dtype", DT)
def test_evoformer_block_vs_interpret(dtype, block_params, feats):
    (tm, tz), (jm, jz) = _blocks(dtype, block_params, feats, "interpret")
    assert_close(tm, jm, MODULE_TOL[dtype], "msa")
    assert_close(tz, jz, MODULE_TOL[dtype], "pair")


@pytest.mark.parametrize("dtype", DT)
def test_evoformer_block(dtype, block_params, feats):
    (tm, tz), (jm, jz) = _blocks(dtype, block_params, feats, "default")
    assert_close(tm, jm, MODULE_TOL[dtype], "msa")
    assert_close(tz, jz, MODULE_TOL[dtype], "pair")


@pytest.mark.parametrize("dtype", DT)
@pytest.mark.parametrize("gate", [True, False])
def test_project_qkv_output_proj(gate, dtype):
    rng = np.random.default_rng(6)
    dims_j = jattn.AttnDims(4, 4, 8)
    dims_t = tattn.AttnDims(4, 4, 8)
    tree = jax.tree.map(np.asarray, jattn.init_attention(
        jax.random.PRNGKey(1), 32, 4, 4, 8, gating=gate, out_bias=True))
    jp, tp = _pair_of_trees(randomize_tree(tree, 12))
    xj, xt = both(normal(rng, (B, 3, 7, 32)), dtype)
    qkv_j = jattn.project_qkv(jp, xj, dims_j, compute_dtype=xj.dtype)
    qkv_t = tattn.project_qkv(tp, xt, dims_t, compute_dtype=xt.dtype)
    for name, a, b in zip("qkv", qkv_t, qkv_j):
        assert_close(a, b, MODULE_TOL[dtype], name)
    ctx_j, ctx_t = both(normal(rng, (B, 3, 7, 4, 8)), dtype)
    assert_close(tattn.output_proj(tp, ctx_t, x_for_gate=xt),
                 jattn.output_proj(jp, ctx_j, x_for_gate=xj),
                 MODULE_TOL[dtype], "output_proj")


@pytest.mark.parametrize("dtype", DT)
def test_transition(dtype):
    rng = np.random.default_rng(7)
    tree = jax.tree.map(np.asarray, jmlp.init_transition(
        jax.random.PRNGKey(2), 16, 4))
    jp, tp = _pair_of_trees(randomize_tree(tree, 13))
    xj, xt = both(normal(rng, (B, R, R, 16)), dtype)
    assert_close(tmlp.transition(tp, xt), jmlp.transition(jp, xj),
                 MODULE_TOL[dtype], "transition")


def test_structure_module(feats):
    rng = np.random.default_rng(8)
    cfg_j, cfg_t = J_SMOKE.structure, T_SMOKE.structure
    tree = jax.tree.map(np.asarray, jst.init_structure_module(
        jax.random.PRNGKey(3), cfg_j))
    jp, tp = _pair_of_trees(randomize_tree(tree, 14))
    sj, st = both(normal(rng, (B, R, cfg_j.c_s)), "float32")
    zj, zt = both(normal(rng, (B, R, R, cfg_j.c_z)), "float32")
    jc, (jr, jt), (jtr, jtt) = jst.structure_module(
        jp, sj, zj, jnp.asarray(feats["seq_mask"]), cfg_j)
    tc, (tr, tt), (ttr, ttt) = tst.structure_module(
        tp, st, zt, torch.as_tensor(feats["seq_mask"]), cfg_t)
    for name, a, b in (("coords", tc, jc), ("rot", tr, jr),
                       ("traj_rot", ttr, jtr), ("traj_trans", ttt, jtt)):
        assert_close(a, b, MODULE_TOL["float32"], name)


@pytest.mark.parametrize("dtype", DT)
def test_embed_recycle(dtype, feats):
    rng = np.random.default_rng(9)
    cfg_j = dataclasses.replace(J_SMOKE, compute_dtype=both(np.zeros(1), dtype)[0].dtype)
    cfg_t = dataclasses.replace(T_SMOKE, compute_dtype=both(np.zeros(1), dtype)[1].dtype)
    tree = jax.tree.map(np.asarray, {"recycle": {
        "ln_m": init_layer_norm(J_EVO.d_msa),
        "ln_z": init_layer_norm(J_EVO.d_pair),
        "dist_embed": init_dense(jax.random.PRNGKey(4), J_SMOKE.recycle_bins,
                                 J_EVO.d_pair)}})
    tree = randomize_tree(tree, 15)
    jp, tp = _pair_of_trees(tree)
    msa_j, msa_t = both(feats["msa"], dtype)
    pair_j, pair_t = both(feats["pair"], dtype)
    prev = (normal(rng, (B, R, J_EVO.d_msa)),
            normal(rng, (B, R, R, J_EVO.d_pair)),
            normal(rng, (B, R, 3), 8.0))
    jm, jz = jaf.embed_recycle(jp, msa_j, pair_j,
                               tuple(jnp.asarray(x) for x in prev), cfg_j)
    tm, tz = taf.embed_recycle(tp, msa_t, pair_t,
                               tuple(torch.as_tensor(x) for x in prev), cfg_t)
    assert_close(tm, jm, MODULE_TOL[dtype], "msa")
    assert_close(tz, jz, MODULE_TOL[dtype], "pair")


@pytest.mark.parametrize("dtype", DT)
def test_evoformer_block_train_dropout(dtype, block_params, feats):
    """One block with train=True and the reference's own dropout masks
    (drawn from its rng as it draws them, handed to the port): the outputs,
    and in fp32 the gradients of every parameter of the block and of both
    inputs. Gradients through a whole block are not held in bf16: there the
    reference's own bf16 gradients differ from its fp32 ones by up to 7%
    of their largest value at this size (measured with these inputs), the
    rounding of both directions compounding over the block, as far as the
    port's bf16 gradients differ from either; each op's backward is held in
    bf16 in test_torch_kernels."""
    jp, tp = block_params
    msa_j, msa_t = both(feats["msa"], dtype)
    pair_j, pair_t = both(feats["pair"], dtype)
    mj, mt = _masks(feats)
    rng = jax.random.PRNGKey(5)
    # The stack splits its rng over blocks; one block gets the first key.
    keeps = jax_dropout_keeps(rng, dataclasses.replace(J_EVO, n_blocks=1),
                              (B, S, R))[0]
    block_key = jax.random.split(rng, 1)[0]

    def j_loss(p, m, z):
        m2, z2 = jevo.evoformer_block(p, m, z, mj["msa_mask"], mj["seq_mask"],
                                      mj["pair_mask"], dist=LocalDist(),
                                      cfg=J_EVO, rng=block_key, train=True)
        return (jnp.sum(jnp.sin(m2.astype(jnp.float32)))
                + jnp.sum(jnp.sin(z2.astype(jnp.float32)))), (m2, z2)

    with use_plan(preset("default")):
        if dtype == "float32":
            (_, (jm, jz)), jg = jax.value_and_grad(
                j_loss, argnums=(0, 1, 2), has_aux=True)(jp, msa_j, pair_j)
        else:
            _, (jm, jz) = j_loss(jp, msa_j, pair_j)
    live = jax.tree.map(lambda t: t.clone().requires_grad_(True), tp)
    m_in = msa_t.clone().requires_grad_(True)
    z_in = pair_t.clone().requires_grad_(True)
    tm, tz = tevo.evoformer_block(live, m_in, z_in, mt["msa_mask"],
                                  mt["seq_mask"], mt["pair_mask"], cfg=T_EVO,
                                  keeps=keeps)
    assert_close(tm, jm, MODULE_TOL[dtype], "msa")
    assert_close(tz, jz, MODULE_TOL[dtype], "pair")
    if dtype != "float32":
        return
    (torch.sin(tm.float()).sum() + torch.sin(tz.float()).sum()).backward()
    assert_close(m_in.grad, jg[1], MODULE_TOL[dtype], "d msa")
    assert_close(z_in.grad, jg[2], MODULE_TOL[dtype], "d pair")
    want = dict(jax.tree_util.tree_leaves_with_path(jg[0]))
    got = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.grad, live)))
    assert got.keys() == want.keys()
    for path, w in want.items():
        assert_close(got[path], w, MODULE_TOL[dtype], jax.tree_util.keystr(path))
