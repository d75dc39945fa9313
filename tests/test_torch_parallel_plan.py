"""The port's sharding plans (``repro_torch.parallel.plan``) against the
reference's (``repro.parallel.plan``) on all ten decoder architectures at
full width: every parameter, optimizer-moment and cache leaf gets the
reference's spec, its stacked layer axis left out, on the reference's
(16, 16) and (2, 16, 16) meshes and on the port's production meshes; the
per-device bytes of a train state under the specs equal the sum over the
reference's. Shapes come from ``jax.eval_shape`` on the reference and from
meta tensors on the port; the reference gets a mesh that has only
``.shape``."""
import dataclasses
from functools import lru_cache

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jax_config
from repro.models import decoder as jdec
from repro.parallel import plan as jplan
from repro.train.loop import make_train_step as jax_train_step
from repro_torch.configs import INPUT_SHAPES, get_config, list_archs
from repro_torch.launch.mesh import make_production_mesh, mesh_of
from repro_torch.models import decoder as tdec
from repro_torch.parallel import plan as tplan
from repro_torch.train.loop import make_train_step

ARCHS = list_archs()
MESHES = {"16x16": mesh_of((16, 16)), "2x16x16": mesh_of((2, 16, 16)),
          "32x8": make_production_mesh(),
          "2x32x8": make_production_mesh(multi_pod=True)}


class ShapeOnly:
    """A mesh the reference's plan can read: ``.shape`` and nothing else."""

    def __init__(self, mesh):
        self.shape = mesh.shape


@lru_cache(maxsize=None)
def ref_params(arch):
    return jax.eval_shape(lambda: jdec.init_model(jax.random.PRNGKey(0),
                                                  jax_config(arch)))


@lru_cache(maxsize=None)
def port_params(arch):
    with torch.device("meta"):
        return tdec.init_model(None, get_config(arch))


def _ref_flat(spec_tree, stacked_at):
    """{path: spec tuple} of a reference spec tree, the leading axis of a
    stacked leaf (``stacked_at(path)``) left out."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        spec_tree, is_leaf=lambda x: isinstance(x, P))
    out = {}
    for path, spec in flat:
        p = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path)
        out[p] = tuple(spec)[1:] if stacked_at(p) else tuple(spec)
    return out


def _port_flat(spec_tree, leaf_tree):
    """{path: spec} of a port spec tree over ``leaf_tree``, keyed by the
    reference's path; every layer of a stack must agree."""
    out: dict = {}

    def walk(specs, leaves, path):
        if isinstance(leaves, dict):
            for k in leaves:
                walk(specs[k], leaves[k], path + (str(k),))
        elif tplan._is_stack(leaves):
            for s, l in zip(specs, leaves):
                walk(s, l, path)
        elif isinstance(leaves, (list, tuple)):
            for i, (s, l) in enumerate(zip(specs, leaves)):
                walk(s, l, path + (str(i),))
        else:
            out.setdefault("/".join(path), set()).add(specs)

    walk(spec_tree, leaf_tree, ())
    for p, specs in out.items():
        assert len(specs) == 1, (p, specs)
    return {p: next(iter(s)) for p, s in out.items()}


def _is_stage(p):
    return p.startswith("stages/")


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_moment_specs(arch, mesh):
    """``model_param_specs`` (sharded or replicated by the fp32 size, as the
    reference decides) and the m/v specs of ``train_state_specs``, leaf for
    leaf; and each device's bytes of the train state."""
    m = MESHES[mesh]
    jp, tp = ref_params(arch), port_params(arch)
    want = _ref_flat(jplan.model_param_specs(jp, ShapeOnly(m)), _is_stage)
    got = _port_flat(tplan.model_param_specs(tp, m), tp)
    assert got == want

    jinit, _ = jax_train_step(lambda p, b, r: (0.0, {}))
    jstate = jax.eval_shape(lambda: jinit(jp))
    j_specs = jplan.train_state_specs(jstate, ShapeOnly(m),
                                      jplan.model_param_specs(jp,
                                                              ShapeOnly(m)))
    tinit, _ = make_train_step(lambda *a: None)
    with torch.device("meta"):
        tstate = tinit(tp)
    t_specs = tplan.train_state_specs(tstate, m,
                                      tplan.model_param_specs(tp, m))
    for part in ("m", "v"):
        assert (_port_flat(getattr(t_specs.opt_state, part), tp)
                == _ref_flat(getattr(j_specs.opt_state, part), _is_stage))

    # Per-device bytes: the reference's leaves under its specs, summed.
    def ref_bytes(leaf, spec):
        n = 1
        for i, dim in enumerate(leaf.shape):
            entry = spec[i] if i < len(spec) else None
            k = 1
            for a in (() if entry is None else (entry,) if isinstance(
                    entry, str) else entry):
                k *= m.shape[a]
            n *= -(-dim // k)
        return n * leaf.dtype.itemsize

    flat_leaves = jax.tree.leaves(jstate)
    flat_specs = jax.tree.leaves(j_specs, is_leaf=lambda x: isinstance(x, P))
    want_bytes = sum(ref_bytes(l, s) for l, s in zip(flat_leaves, flat_specs))
    assert tplan.device_bytes(tstate, t_specs, m) == want_bytes


SERVE_SHAPES = ["prefill_32k", "decode_32k", "long_500k"]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs(arch, mesh):
    """``cache_specs`` of the caches ``init_cache`` makes, leaf for leaf, at
    every serving shape's batch and length."""
    m = MESHES[mesh]
    jcfg, tcfg = jax_config(arch), get_config(arch)
    for name in SERVE_SHAPES:
        shape = INPUT_SHAPES[name]
        jcache = jax.eval_shape(lambda: jdec.init_cache(
            jcfg, shape.global_batch, shape.seq_len))
        with torch.device("meta"):
            tcache = tdec.init_cache(tcfg, shape.global_batch, shape.seq_len)
        want = _ref_flat(jplan.cache_specs(jcache, ShapeOnly(m), shape,
                                           jcfg), lambda p: True)
        got = _port_flat(tplan.cache_specs(tcache, m, shape, tcfg), tcache)
        assert got == want, name


@pytest.mark.parametrize("mesh", list(MESHES))
def test_token_and_sequence_specs(mesh):
    m = MESHES[mesh]
    for shape in INPUT_SHAPES.values():
        assert tplan.token_spec(m, shape) == tuple(
            jplan.token_spec(ShapeOnly(m), shape))
        assert tplan.seq_axes(m, shape) == jplan.seq_axes(ShapeOnly(m),
                                                          shape)
    assert tplan.batch_axes(m) == jplan.batch_axes(ShapeOnly(m))


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "deepseek-v2-236b",
                                  "qwen2-1.5b"])
def test_moe_with_groups(arch):
    m = make_production_mesh()
    got = tplan.moe_with_groups(get_config(arch), m)
    want = jplan.moe_with_groups(jax_config(arch), ShapeOnly(m))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
