"""The port's folding inference as a whole against the JAX package: the
SMOKE model (2 blocks, n_recycle=1) on fully randomised weights, served
through ``FastFold(device="cpu").serve`` for a full-length and a padded
request, against the reference's ``alphafold_forward`` under
``preset("default")``, whose fused triangle and OPM branch the port takes.
Plus the parameter bridge, the port's own initializer and the data
generator.

The whole-forward comparison is made in fp32 (bound 1e-3 * max(1, max|jax|)).
In bf16 the two frameworks round at a few different places in each module
(one bf16 ulp, see test_torch_modules); through 2 blocks, 2 passes and the
structure module on random weights those differences compound past any
bound that would still catch a wrong kernel, so bf16 is held per module and
per block instead."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.alphafold import SMOKE as J_SMOKE
from repro.core.alphafold import alphafold_forward, init_alphafold
from repro.data import protein_batches as j_protein_batches
from repro.exec.plan import preset, use_plan
from repro_torch.configs import SMOKE as T_SMOKE
from repro_torch.data import protein_batches
from repro_torch.exec import FastFold
from repro_torch.weights import (params_from_numpy, params_to_numpy,
                                 randomize_tree)
from torch_parity import FORWARD_TOL, assert_close

OUTPUTS = ("coords", "msa_logits", "distogram_logits", "msa", "pair")


@pytest.fixture(scope="module")
def jax_tree():
    init = jax.jit(init_alphafold, static_argnums=1)
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), J_SMOKE))


def test_serve_matches_reference(jax_tree):
    tree = randomize_tree(jax_tree, 21)
    requests = [
        next(protein_batches(batch=1, n_seq=6, n_res=12, seed=1)).as_dict(),
        next(protein_batches(batch=2, n_seq=5, n_res=12, seed=2,
                             n_real=8)).as_dict(),
    ]
    ff = FastFold(T_SMOKE, device="cpu", dtype=torch.float32)
    outs = ff.serve(params_from_numpy(tree, device="cpu"), requests)
    j_cfg = dataclasses.replace(J_SMOKE, compute_dtype=jnp.float32)
    j_params = jax.tree.map(jnp.asarray, tree)
    with use_plan(preset("default")):
        j_forward = jax.jit(lambda p, b: alphafold_forward(p, b, j_cfg))
        for req, got in zip(requests, outs):
            want = j_forward(j_params, {k: jnp.asarray(v)
                                        for k, v in req.items()})
            for k in OUTPUTS:
                assert got[k].dtype == torch.float32
                assert_close(got[k], want[k], FORWARD_TOL["float32"], k)


def test_padding_leaves_real_residues_alone(jax_tree):
    """A request padded from 8 to 12 residues: the masks are zeroed on the
    tail, the features of the real residues are unchanged, and the forward
    stays finite."""
    full = next(protein_batches(batch=1, n_seq=4, n_res=12, seed=3))
    pad = next(protein_batches(batch=1, n_seq=4, n_res=12, seed=3, n_real=8))
    assert pad.seq_mask[0, 8:].sum() == 0 and pad.seq_mask[0, :8].all()
    assert pad.msa_mask[..., 8:].sum() == 0 and pad.msa_mask[..., :8].all()
    np.testing.assert_array_equal(pad.msa, full.msa)
    ff = FastFold(T_SMOKE, device="cpu")
    out = ff.forward(params_from_numpy(randomize_tree(jax_tree, 22),
                                       device="cpu"), pad.as_dict())
    for k in OUTPUTS:
        assert torch.isfinite(out[k].float()).all(), k


def test_data_generator_is_byte_identical():
    got = next(protein_batches(batch=2, n_seq=5, n_res=9, seed=7))
    want = next(j_protein_batches(batch=2, n_seq=5, n_res=9, seed=7))
    for k, v in got.as_dict().items():
        ref = getattr(want, k)
        assert v.dtype == ref.dtype and v.tobytes() == ref.tobytes(), k


def test_params_bridge_round_trip(jax_tree):
    tree = randomize_tree(jax_tree, 23)
    params = params_from_numpy(tree, device="cpu")
    assert len(params["evoformer"]) == J_SMOKE.evoformer.n_blocks
    back = params_to_numpy(params)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


def test_port_init_matches_reference_scheme(jax_tree):
    """The port's own initializer: the reference's tree, shapes and scheme
    (zero-initialised output projections, unit gate biases, unit gammas)."""
    mine = params_to_numpy(FastFold(T_SMOKE, device="cpu").init(seed=0))
    ref = dict(jax.tree_util.tree_leaves_with_path(jax_tree))
    got = dict(jax.tree_util.tree_leaves_with_path(mine))
    assert got.keys() == ref.keys()
    for path, leaf in ref.items():
        assert got[path].shape == leaf.shape, path
        if not leaf.any():
            assert not got[path].any(), path
        elif (leaf == 1).all():
            assert (got[path] == 1).all(), path
        else:
            # truncated normal at +-2 std, std = 1/sqrt(fan_in)
            bound = 2.0 / np.sqrt(leaf.shape[-2]) + 1e-6
            assert np.abs(got[path]).max() <= bound, path
            assert got[path].std() > 0.3 / np.sqrt(leaf.shape[-2]), path
