"""The port's Dynamic Axial Parallelism (``repro_torch.core.dap``, the DAP
Evoformer of ``core/evoformer.py`` on ``core.dist.ProcessGroupDist``)
against the JAX package, on gloo groups of 2 and 4 spawned CPU processes
(JAX runs only in this process and in one subprocess of 4 host devices).

At the reference's DAP test widths (d_msa 32, d_pair 16, 4 and 2 heads,
head dim 8, OPM 8, triangle 16, 2 blocks; B = 2, s = 8, r = 12), fp32,
every weight randomised, masks with zeros:
  - each DAP module, fed the rank's shards, its output gathered, against
    the reference's module (LocalDist) at 1e-4 * max(1, max|jax|);
  - the stack at N = 2 and 4 against the reference's ``evoformer_stack``
    and, at N = 4, its ``dap_evoformer_stack`` at 1e-3;
  - the gradients of sum(sin(msa)) + sum(sin(pair)) with respect to every
    parameter and both inputs against ``jax.grad`` of the reference's
    stack at 1e-3;
  - the collectives of one block: the reference block's 8 all-to-alls and
    7 all-gathers forward (derived below), and their duals backward;
  - the whole model under DAP (``FastFold(SMOKE)`` with the "gspmd"
    policy, N = 2): the loss and every gradient equal to the port's local
    run at 1e-3 with dropout off (and so to the reference's) and on, and
    every rank's parameters and moments equal to the bit after two AdamW
    steps.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.alphafold import SMOKE as J_SMOKE
from repro.core import evoformer as jevo
from repro.core.alphafold import alphafold_train_loss as j_train_loss
from repro.core.alphafold import init_alphafold
from repro.core.dist import LocalDist as JLocal
from repro.exec.plan import preset, use_plan
from repro_torch.core import dist as D
from repro_torch.data import protein_batches
from repro_torch.weights import randomize_tree
import torch_dist_cases as cases
from torch_parity import FORWARD_TOL, MODULE_TOL, assert_close

CFG_KW = dict(d_msa=32, d_pair=16, msa_heads=4, pair_heads=2, head_dim=8,
              opm_dim=8, tri_mult_dim=16, n_blocks=2)
J_CFG = jevo.EvoformerConfig(**CFG_KW, compute_dtype=jnp.float32)
B, S, R = 2, 8, 12
SIZES = (2, 4)
SRC = os.path.join(os.path.dirname(__file__), "..", "src")

# Per block forward, as the reference's evoformer_block launches them
# (src/repro/core/evoformer.py:279-562): all-to-alls: the MSA to the r
# shard and back, the MSA mask, and transpose_pair of the pair, the pair
# mask, the incoming update, the pair again and the ending-node update;
# all-gathers: the MSA-row bias, the OPM's right projection and its mask,
# both triangle updates' b, and both triangle attentions' biases.
A2A_PER_BLOCK = 2 + 1 + 5
GATHER_PER_BLOCK = 1 + 2 + 2 + 2
# Backward: the dual of each collective whose input needs a gradient, so
# not of the two mask all-to-alls nor of the OPM mask's all-gather; and one
# all-reduce of the block's parameter gradients.
A2A_BWD_PER_BLOCK = A2A_PER_BLOCK - 2
RS_BWD_PER_BLOCK = GATHER_PER_BLOCK - 1

JAX_DAP = r"""
import pickle, sys
import numpy as np, jax, jax.numpy as jnp
jax.config.update("jax_default_matmul_precision", "highest")
from repro.core.evoformer import EvoformerConfig
from repro.core.dap import dap_evoformer_stack, shard_dap_inputs
from repro.launch.mesh import _mesh
tree, feats, cfg_kw, out = pickle.load(open(sys.argv[1], "rb"))
cfg = EvoformerConfig(**cfg_kw, compute_dtype=jnp.float32)
mesh = _mesh((1, 4), ("data", "model"))
fn = jax.jit(dap_evoformer_stack(mesh, cfg, remat=False))
args = shard_dap_inputs(mesh, *[jnp.asarray(f) for f in feats])
m, z = fn(jax.tree.map(jnp.asarray, tree), *args)
np.savez(out, msa=np.asarray(m), pair=np.asarray(z))
"""


@pytest.fixture(scope="module")
def tree():
    init = jax.jit(jevo.init_evoformer_stack, static_argnums=1)
    return randomize_tree(jax.tree.map(np.asarray,
                                       init(jax.random.PRNGKey(0), J_CFG)), 23)


@pytest.fixture(scope="module")
def feats():
    rng = np.random.default_rng(5)
    msa = rng.standard_normal((B, S, R, J_CFG.d_msa)).astype(np.float32)
    pair = rng.standard_normal((B, R, R, J_CFG.d_pair)).astype(np.float32)
    msa_mask = (rng.random((B, S, R)) < 0.85).astype(np.float32)
    seq_mask = np.ones((B, R), np.float32)
    seq_mask[1, -2:] = 0.0
    pair_mask = seq_mask[:, :, None] * seq_mask[:, None, :]
    return msa, pair, msa_mask, seq_mask, pair_mask


@pytest.fixture(scope="module")
def smoke():
    """The SMOKE model's randomised tree and unpadded batches (s and r
    divisible by 2)."""
    init = jax.jit(init_alphafold, static_argnums=1)
    tree = randomize_tree(jax.tree.map(
        np.asarray, init(jax.random.PRNGKey(0), J_SMOKE)), 31)
    gen = protein_batches(batch=1, n_seq=8, n_res=12, seed=4)
    return tree, [next(gen).as_dict() for _ in range(3)]


@pytest.fixture(scope="module")
def ranks(tree, feats, smoke):
    """{N: [rank results]} of the port, and the reference's DAP stack at
    N = 4 from a subprocess run beside them."""
    with tempfile.TemporaryDirectory() as tmp:
        path, out = os.path.join(tmp, "in.pkl"), os.path.join(tmp, "out.npz")
        with open(path, "wb") as f:
            pickle.dump((tree, feats, CFG_KW, out), f)
        env = dict(os.environ, PYTHONPATH=SRC,
                   XLA_FLAGS="--xla_force_host_platform_device_count=4")
        proc = subprocess.Popen([sys.executable, "-c", JAX_DAP, path],
                                env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        try:
            with ThreadPoolExecutor(3) as pool:
                runs = {n: pool.submit(D.run_ranks, cases.dap_stack_cases, n,
                                       tree, feats, CFG_KW, timeout_s=240)
                        for n in SIZES}
                runs["whole"] = pool.submit(
                    D.run_ranks, cases.whole_model_cases, 2, smoke[0],
                    smoke[1][0], smoke[1][1:], timeout_s=240)
                res = {k: f.result() for k, f in runs.items()}
            _, err = proc.communicate(timeout=300)
        finally:
            proc.kill()
        assert proc.returncode == 0, err
        with np.load(out) as z:
            res["jax_dap4"] = (z["msa"], z["pair"])
    return res


def _j(feats):
    return [jnp.asarray(f) for f in feats]


def _jax_stack(tree, msa, pair, msa_mask, seq_mask, pair_mask):
    return jevo.evoformer_stack(tree, msa, pair, msa_mask, seq_mask,
                                pair_mask, dist=JLocal(), cfg=J_CFG,
                                remat=False)


@pytest.fixture(scope="module")
def jax_stack(tree, feats):
    """The reference's local stack: outputs, and the gradients of
    sum(sin(msa)) + sum(sin(pair)) w.r.t. the parameters and inputs."""
    def loss(p, m, z, *masks):
        mo, zo = _jax_stack(p, m, z, *masks)
        return jnp.sum(jnp.sin(mo)) + jnp.sum(jnp.sin(zo))

    jt = jax.tree.map(jnp.asarray, tree)
    with use_plan(preset("default")):
        out = jax.jit(_jax_stack)(jt, *_j(feats))
        grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(jt, *_j(feats))
    return out, grads


MODULES = ("msa_row", "msa_col", "opm", "tri_mult_out", "tri_mult_in",
           "tri_attn_start", "tri_attn_end")


def _jax_module(site, tree, feats):
    p = jax.tree.map(lambda x: jnp.asarray(x[0]), tree)
    msa, pair, msa_mask, seq_mask, pair_mask = _j(feats)
    d, e = JLocal(), jevo
    return {
        "msa_row": lambda: e.msa_row_attention(p["msa_row"], msa, pair,
                                               seq_mask, d, J_CFG),
        "msa_col": lambda: e.msa_col_attention(p["msa_col"], msa, msa_mask,
                                               d, J_CFG),
        "opm": lambda: e.outer_product_mean(p["opm"], msa, msa_mask, d,
                                            J_CFG),
        "tri_mult_out": lambda: e.triangle_mult_outgoing(
            p["tri_mult_out"], pair, pair_mask, d, J_CFG),
        "tri_mult_in": lambda: e.triangle_mult_incoming(
            p["tri_mult_in"], pair, e.transpose_pair(pair, d),
            e.transpose_pair(pair_mask[..., None], d)[..., 0], d, J_CFG),
        "tri_attn_start": lambda: e.triangle_attention(
            p["tri_attn_start"], pair, seq_mask, d, J_CFG),
        "tri_attn_end": lambda: e.transpose_pair(e.triangle_attention(
            p["tri_attn_end"], e.transpose_pair(pair, d), seq_mask, d, J_CFG),
            d),
    }[site]()


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("site", MODULES)
def test_dap_module_matches_reference(site, n, ranks, tree, feats):
    with use_plan(preset("default")):
        want = _jax_module(site, tree, feats)
    for r, res in enumerate(ranks[n]):
        assert_close(res[site], want, MODULE_TOL["float32"],
                     f"{site} N={n} rank {r}")


@pytest.mark.parametrize("n", SIZES)
def test_dap_stack_matches_reference(n, ranks, jax_stack):
    (m_want, z_want), _ = jax_stack
    for r, res in enumerate(ranks[n]):
        m, z = res["stack"]
        assert_close(m, m_want, FORWARD_TOL["float32"], f"msa N={n} rank {r}")
        assert_close(z, z_want, FORWARD_TOL["float32"], f"pair N={n} rank {r}")


def test_dap_stack_matches_the_reference_dap_stack(ranks):
    m_want, z_want = ranks["jax_dap4"]
    m, z = ranks[4][0]["stack"]
    assert_close(m, m_want, FORWARD_TOL["float32"], "msa")
    assert_close(z, z_want, FORWARD_TOL["float32"], "pair")


def _port_leaves(tree) -> list:
    """The leaves of a reference parameter tree (numpy or JAX, the
    Evoformer's stacked or not) in the order of the port's parameters."""
    from repro_torch.layers.params import tree_leaves
    from repro_torch.weights import params_from_numpy

    return [t.numpy() for t in tree_leaves(params_from_numpy(
        jax.tree.map(np.asarray, tree), device="cpu"))]


@pytest.mark.parametrize("n", SIZES)
def test_dap_gradients_match_reference(n, ranks, jax_stack):
    _, (g_params, g_msa, g_pair) = jax_stack
    want = _port_leaves({"evoformer": g_params})
    for r, res in enumerate(ranks[n]):
        assert len(res["param_grads"]) == len(want)
        for i, (got, w) in enumerate(zip(res["param_grads"], want)):
            assert_close(got, w, FORWARD_TOL["float32"],
                         f"N={n} rank {r} parameter {i}")
        assert_close(res["input_grads"][0], g_msa, FORWARD_TOL["float32"],
                     f"N={n} rank {r} d msa")
        assert_close(res["input_grads"][1], g_pair, FORWARD_TOL["float32"],
                     f"N={n} rank {r} d pair")


@pytest.mark.parametrize("n", SIZES)
def test_dap_collectives_per_block(n, ranks):
    nb = CFG_KW["n_blocks"]
    for r, res in enumerate(ranks[n]):
        fwd, bwd = res["collectives"]["forward"], res["collectives"]["backward"]
        assert fwd["all_to_all"]["forward"]["calls"] == A2A_PER_BLOCK * nb
        assert fwd["all_gather"]["forward"]["calls"] == GATHER_PER_BLOCK * nb
        assert set(fwd) == {"all_to_all", "all_gather"}, (r, fwd)
        assert bwd["all_to_all"]["backward"]["calls"] == A2A_BWD_PER_BLOCK * nb
        assert (bwd["reduce_scatter"]["backward"]["calls"]
                == RS_BWD_PER_BLOCK * nb)
        assert bwd["all_reduce"]["backward"]["calls"] == nb
        assert "forward" not in bwd.get("all_to_all", {}), (r, bwd)


@pytest.mark.parametrize("dropout", ["off", "on"])
def test_whole_model_matches_the_local_model(dropout, ranks):
    """The whole SMOKE model under the "gspmd" policy: the loss and every
    gradient equal to the port's local run on each rank (dropout on: masks
    drawn whole from generators seeded alike, each rank its shard)."""
    for r, res in enumerate(ranks["whole"]):
        loss, grads = res[("dap", dropout)]
        want_loss, want = res[("local", dropout)]
        assert abs(loss - want_loss) <= 1e-4 * abs(want_loss), (r, loss)
        assert len(grads) == len(want)
        for i, (g, w) in enumerate(zip(grads, want)):
            assert_close(g, w, FORWARD_TOL["float32"], f"rank {r} leaf {i}")


def test_whole_model_matches_the_reference(ranks, smoke):
    """Dropout off, the whole model under DAP against the reference's train
    loss and ``jax.value_and_grad`` of it."""
    tree, batches = smoke
    j_cfg = dataclasses.replace(J_SMOKE, compute_dtype=jnp.float32)
    with use_plan(preset("default")):
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p, b: j_train_loss(p, b, j_cfg, rng=None), has_aux=True))(
            jax.tree.map(jnp.asarray, tree),
            {k: jnp.asarray(v) for k, v in batches[0].items()})
    want = _port_leaves(grads)
    got_loss, got = ranks["whole"][0][("dap", "off")]
    assert abs(got_loss - float(loss)) <= 1e-4 * abs(float(loss))
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close(g, w, FORWARD_TOL["float32"], f"leaf {i}")


def test_ranks_hold_equal_parameters_after_two_steps(ranks):
    (l0, p0, m0), (l1, p1, m1) = (r[("dap", "steps")]
                                  for r in ranks["whole"])
    assert l0 == l1
    assert all(np.array_equal(a, b) for a, b in zip(p0, p1))
    assert all(np.array_equal(a, b) for a, b in zip(m0, m1))
    local_loss = ranks["whole"][0][("local", "steps")][0]
    assert abs(l0 - local_loss) <= 1e-4 * abs(local_loss)


@pytest.mark.parametrize("fused", [True, False])
def test_autochunk_counts_the_gathered_operands_per_rank(fused):
    """AutoChunk's per-rank terms under DAP hold the whole (B, H, r, r)
    pair bias and the whole gathered triangle b: on the kernel branch b and
    its all-gather's receive buffer, on the materialized branch the
    buffer (its operands count b itself)."""
    from repro_torch.configs import FULL
    from repro_torch.memory.autochunk import evoformer_peak_bytes

    evo, r = FULL.evoformer, 256
    kw = dict(batch=1, n_seq=128, n_res=r, fused=fused)
    one = evoformer_peak_bytes(evo, dap=1, **kw)
    two = evoformer_peak_bytes(evo, dap=2, **kw)
    assert "gathers" not in one
    assert two["pair_bias"] == one["pair_bias"] == evo.msa_heads * r * r * 2
    assert two["gathers"] == (2 if fused else 1) * r * r * evo.tri_mult_dim * 2
    assert two["pair_rep"] * 2 == one["pair_rep"]
