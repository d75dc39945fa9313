"""The port's tensor-parallel Evoformer (``repro_torch.core.tp``, the
paper's baseline) against the JAX package and the port's local stack, on
gloo groups of spawned CPU processes, at the reference's TP test widths
(d_msa 32, d_pair 16, 4 and 2 heads, head dim 8, 2 blocks; B = 2, s = 6,
r = 10), fp32, every weight randomised, masks with zeros:
  - the TP stack at N = 2 against the reference's ``tp_evoformer_stack`` on
    2 host devices (a subprocess) and against the reference's local stack,
    at 1e-3 * max(1, max|jax|);
  - 6 all-reduces a block forward (the reference's assertion,
    tests/test_distributed.py);
  - the gradients of sum(sin(msa)) + sum(sin(pair)) with respect to every
    parameter and both inputs against ``jax.grad`` of the local stack at
    1e-3, on every rank (Megatron's f/g pair; sliced parameters' gradients
    summed over the ranks, replicated ones not);
  - N = 4 with 2 pair heads raises (the scaling limit the paper argues
    DAP away).
"""
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

from repro.core import evoformer as jevo
from repro.core.dist import LocalDist as JLocal
from repro.exec.plan import preset, use_plan
from repro_torch.core import dist as D
from repro_torch.layers.params import tree_leaves
from repro_torch.weights import params_from_numpy, randomize_tree
import torch_dist_cases as cases
from torch_parity import FORWARD_TOL, assert_close

CFG_KW = dict(d_msa=32, d_pair=16, msa_heads=4, pair_heads=2, head_dim=8,
              opm_dim=8, tri_mult_dim=16, n_blocks=2)
J_CFG = jevo.EvoformerConfig(**CFG_KW, compute_dtype=jnp.float32)
B, S, R = 2, 6, 10
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
# paper Table III: 6 all-reduces in the forward pass of a block.
ALL_REDUCES_PER_BLOCK = 6

JAX_TP = r"""
import pickle, sys
import numpy as np, jax, jax.numpy as jnp
jax.config.update("jax_default_matmul_precision", "highest")
from repro.core.evoformer import EvoformerConfig
from repro.core.tp import tp_evoformer_stack
from repro.launch.mesh import _mesh
tree, feats, cfg_kw, out = pickle.load(open(sys.argv[1], "rb"))
cfg = EvoformerConfig(**cfg_kw, compute_dtype=jnp.float32)
mesh = _mesh((1, 2), ("data", "model"))
fn = jax.jit(tp_evoformer_stack(mesh, cfg, remat=False))
m, z = fn(jax.tree.map(jnp.asarray, tree), *[jnp.asarray(f) for f in feats])
np.savez(out, msa=np.asarray(m), pair=np.asarray(z))
"""


@pytest.fixture(scope="module")
def tree():
    init = jax.jit(jevo.init_evoformer_stack, static_argnums=1)
    return randomize_tree(jax.tree.map(np.asarray,
                                       init(jax.random.PRNGKey(0), J_CFG)), 29)


@pytest.fixture(scope="module")
def feats():
    rng = np.random.default_rng(8)
    msa = rng.standard_normal((B, S, R, J_CFG.d_msa)).astype(np.float32)
    pair = rng.standard_normal((B, R, R, J_CFG.d_pair)).astype(np.float32)
    msa_mask = (rng.random((B, S, R)) < 0.85).astype(np.float32)
    seq_mask = np.ones((B, R), np.float32)
    seq_mask[0, -3:] = 0.0
    pair_mask = seq_mask[:, :, None] * seq_mask[:, None, :]
    return msa, pair, msa_mask, seq_mask, pair_mask


@pytest.fixture(scope="module")
def ranks(tree, feats):
    """The port's TP at N = 2, its refusal at N = 4, and the reference's TP
    stack from a subprocess of 2 host devices run beside them."""
    with tempfile.TemporaryDirectory() as tmp:
        path, out = os.path.join(tmp, "in.pkl"), os.path.join(tmp, "out.npz")
        with open(path, "wb") as f:
            pickle.dump((tree, feats, CFG_KW, out), f)
        env = dict(os.environ, PYTHONPATH=SRC,
                   XLA_FLAGS="--xla_force_host_platform_device_count=2")
        proc = subprocess.Popen([sys.executable, "-c", JAX_TP, path],
                                env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        try:
            with ThreadPoolExecutor(2) as pool:
                tp = pool.submit(D.run_ranks, cases.tp_cases, 2, tree, feats,
                                 CFG_KW, timeout_s=240)
                refused = pool.submit(D.run_ranks, cases.tp_refuses, 4,
                                      CFG_KW, timeout_s=240)
                res = {"tp": tp.result(), "refused": refused.result()}
            _, err = proc.communicate(timeout=300)
        finally:
            proc.kill()
        assert proc.returncode == 0, err
        with np.load(out) as z:
            res["jax_tp2"] = (z["msa"], z["pair"])
    return res


@pytest.fixture(scope="module")
def jax_local(tree, feats):
    """The reference's local stack and ``jax.grad`` of sum(sin(msa)) +
    sum(sin(pair)) w.r.t. the parameters and both inputs."""
    def stack(p, m, z, *masks):
        return jevo.evoformer_stack(p, m, z, *masks, dist=JLocal(), cfg=J_CFG,
                                    remat=False)

    def loss(p, m, z, *masks):
        mo, zo = stack(p, m, z, *masks)
        return jnp.sum(jnp.sin(mo)) + jnp.sum(jnp.sin(zo))

    jt = jax.tree.map(jnp.asarray, tree)
    xs = [jnp.asarray(f) for f in feats]
    with use_plan(preset("default")):
        out = jax.jit(stack)(jt, *xs)
        grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(jt, *xs)
    return out, grads


@pytest.mark.parametrize("against", ["reference tp", "reference local"])
def test_tp_stack_matches(against, ranks, jax_local):
    want = ranks["jax_tp2"] if against == "reference tp" else jax_local[0]
    for r, res in enumerate(ranks["tp"]):
        m, z = res["forward"]
        assert_close(m, want[0], FORWARD_TOL["float32"], f"msa rank {r}")
        assert_close(z, want[1], FORWARD_TOL["float32"], f"pair rank {r}")


def test_tp_makes_six_all_reduces_a_block(ranks):
    for res in ranks["tp"]:
        counts = res["collectives"]
        assert (counts["all_reduce"]["forward"]["calls"]
                == ALL_REDUCES_PER_BLOCK * CFG_KW["n_blocks"])
        assert set(counts) == {"all_reduce", "reduce_scatter", "all_gather"}
        assert set(counts["reduce_scatter"]) == {"all_reduce"}


def test_tp_gradients_match_the_local_stack(ranks, jax_local):
    _, (g_params, g_msa, g_pair) = jax_local
    want = [t.numpy() for t in tree_leaves(params_from_numpy(
        {"evoformer": jax.tree.map(np.asarray, g_params)}, device="cpu"))]
    for r, res in enumerate(ranks["tp"]):
        assert len(res["param_grads"]) == len(want)
        for i, (got, w) in enumerate(zip(res["param_grads"], want)):
            assert_close(got, w, FORWARD_TOL["float32"], f"rank {r} leaf {i}")
        assert_close(res["input_grads"][0], g_msa, FORWARD_TOL["float32"],
                     f"rank {r} d msa")
        assert_close(res["input_grads"][1], g_pair, FORWARD_TOL["float32"],
                     f"rank {r} d pair")


def test_tp_over_more_ranks_than_pair_heads_raises(ranks):
    for msg in ranks["refused"]:
        assert msg is not None and "pair_heads=2" in msg, msg
