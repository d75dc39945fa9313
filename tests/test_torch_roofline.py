"""The port's roofline (``repro_torch.roofline.analysis``): a counterpart of
each of ``tests/test_roofline.py``'s tests, the FLOP count of one SMOKE
Evoformer block and one reduced qwen2-1.5b layer held against the
reference's ``hlo_cost`` of the same function, each fused op's own count
against the plain version it stands for, and the count of a SMOKE forward
and training step the same whether the CUDA wrappers run (simulated with
their plain versions, as ``test_torch_hygiene.py`` does) or the plain
route runs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs.alphafold import SMOKE as J_SMOKE
from repro.core import evoformer as jevo
from repro.core.dist import LocalDist
from repro.exec.plan import preset, use_plan
from repro.models import decoder as jdec
from repro.roofline import analysis as J
from repro_torch.configs import SMOKE, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import dist
from repro_torch.core import evoformer as tevo
from repro_torch.data import protein_batches
from repro_torch.exec import FastFold
from repro_torch.kernels import ops, ref
from repro_torch.launch import mesh as M
from repro_torch.launch.dryrun import fake_group
from repro_torch.models import decoder as tdec
from repro_torch.roofline import analysis as A
from repro_torch.train import make_train_step
from repro_torch.weights import (decoder_params_from_numpy,
                                 params_from_numpy, randomize_tree)
from torch_parity import both, normal


def test_dtype_bytes():
    assert A.shape_bytes((128, 128), torch.float32) == 128 * 128 * 4
    assert A.shape_bytes((2, 4, 8), torch.bfloat16) == 2 * 4 * 8 * 2
    assert A.io_bytes(torch.empty(4), torch.empty(8, dtype=torch.bfloat16),
                      None) == 16 + 16
    assert A.shape_bytes((16,), torch.bool) == 16
    # A broadcast input reads its distinct elements once.
    assert A.tensor_bytes(torch.empty(1, 8).expand(64, 8)) == 8 * 4
    assert A.tensor_bytes(torch.empty(0, 8)) == 0


def test_collectives_of_a_10_trip_loop_counted_10x():
    """Ten all-gathers in a loop count ten times (an eager program executes
    each); an all-reduce over 4 ranks carries the wire factor 2·3/4, and
    counts once, not again as its two halves."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    dist.reset_collectives()
    with fake_group(4), FakeTensorMode():
        d = dist.ProcessGroupDist()
        x = torch.empty(32, 128)
        for _ in range(10):
            d.start("all_gather", x, axis=0).wait()
        d.all_reduce_tensor(torch.empty(64, 64))
    log = dist.collectives()
    stats = A.collective_stats(log, 4)
    assert stats.counts == {"all-gather": 10, "all-reduce": 1}
    np.testing.assert_allclose(stats.payload_bytes["all-gather"],
                               10 * 128 * 128 * 4)
    np.testing.assert_allclose(stats.payload_bytes["all-reduce"],
                               64 * 64 * 4)
    np.testing.assert_allclose(stats.wire_bytes,
                               10 * 128 * 128 * 4 * 3 / 4
                               + 64 * 64 * 4 * 1.5)
    assert A.count_collective_ops(log, blocks=10) == {"all-gather": 1.0,
                                                      "all-reduce": 0.1}
    assert not torch.distributed.is_initialized()


def test_loop_dot_flops_counted_each_trip():
    a = torch.randn(128, 128)

    def f():
        c = a
        for _ in range(10):
            c = c @ a
        return c

    flops, _ = A.count_cost(f)
    np.testing.assert_allclose(flops, 10 * 2 * 128 ** 3)


def test_matmul_flops_and_bytes():
    n, k, m = 64, 32, 48
    a, b = torch.randn(n, k), torch.randn(k, m)
    flops, nbytes = A.count_cost(lambda: a @ b)
    np.testing.assert_allclose(flops, 2 * n * k * m)
    assert nbytes >= (n * k + k * m + n * m) * 4   # at least one pass of I/O


def test_stacked_weights_layer_loop():
    L = 12
    ws, x = torch.randn(L, 64, 64), torch.randn(64, 64)

    def f():
        c = x
        for i in range(L):
            c = c @ ws[i]
        return c

    flops, _ = A.count_cost(f)
    np.testing.assert_allclose(flops, L * 2 * 64 ** 3, rtol=0.01)


def test_roofline_terms_and_bottleneck():
    r = A.Roofline(flops=M.PEAK_FLOPS_BF16, hbm_bytes=M.HBM_BW * 2,
                   wire_bytes=0.0, chips=1, peak_flops=M.PEAK_FLOPS_BF16,
                   hbm_bw=M.HBM_BW, ici_bw=M.NVLINK_BW)
    np.testing.assert_allclose(r.t_compute, 1.0)
    np.testing.assert_allclose(r.t_memory, 2.0)
    assert r.bottleneck == "memory"
    assert set(r.as_dict()) == set(J.Roofline(1, 1, 1, 1, 1, 1, 1).as_dict())
    # The card's constants, none of the TPU's.
    assert (M.PEAK_FLOPS_BF16, M.HBM_BW) == (989e12, 3.35e12)
    assert M.HBM_BYTES > 80e9


def test_model_flops():
    train = ShapeConfig("t", 1024, 8, "train")
    dec = ShapeConfig("d", 1024, 8, "decode")
    assert A.model_flops(train, 1e9) == 6e9 * 8 * 1024
    assert A.model_flops(dec, 1e9) == 2e9 * 8
    assert A.model_flops(train, 1e9) == J.model_flops(train, 1e9)


def test_wire_factors_are_the_references():
    for op, f in J._WIRE_FACTOR.items():
        assert A._WIRE_FACTOR[op](8) == f(8)


# ---------------------------------------------------------------------------
# The count against the reference's hlo_cost
# ---------------------------------------------------------------------------

def _hlo_flops(fn, *args):
    return J.hlo_cost(jax.jit(fn).lower(*args).compile().as_text())[0]


def test_evoformer_block_flops_match_hlo_cost():
    """One SMOKE-width Evoformer block forward, the reference on its XLA
    legs (the default plan on the CPU), the port on its plain route: the
    same matrix products, within 1%."""
    b, s, r = 2, 6, 12
    init = jax.jit(jevo.init_evoformer_block, static_argnums=1)
    tree = randomize_tree(jax.tree.map(np.asarray, init(
        jax.random.PRNGKey(0), J_SMOKE.evoformer)), 11)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = params_from_numpy({"x": tree}, device="cpu")["x"]
    rng = np.random.default_rng(5)
    msa_j, msa_t = both(normal(rng, (b, s, r, SMOKE.evoformer.d_msa)),
                        "float32")
    pair_j, pair_t = both(normal(rng, (b, r, r, SMOKE.evoformer.d_pair)),
                          "float32")
    masks = [np.ones(shp, np.float32) for shp in ((b, s, r), (b, r),
                                                   (b, r, r))]
    mj = [jnp.asarray(x) for x in masks]
    mt = [torch.as_tensor(x) for x in masks]
    with use_plan(preset("default")):
        want = _hlo_flops(lambda p, m, z, *k: jevo.evoformer_block(
            p, m, z, *k, dist=LocalDist(), cfg=J_SMOKE.evoformer),
            jp, msa_j, pair_j, *mj)
    got, _ = A.count_cost(tevo.evoformer_block, tp, msa_t, pair_t, *mt,
                          cfg=SMOKE.evoformer)
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=0.01)


def test_decoder_layer_flops_match_hlo_cost():
    """One reduced qwen2-1.5b layer's training forward, the same inputs."""
    jcfg = jax_config("qwen2-1.5b", reduced_variant=True)
    tcfg = get_config("qwen2-1.5b", reduced_variant=True)
    tree = randomize_tree(jax.tree.map(np.asarray, jdec.init_model(
        jax.random.PRNGKey(0), jcfg)), 1)
    jlayer = jax.tree.map(lambda x: jnp.asarray(x[0]),
                          tree["stages"][0])
    tlayer = decoder_params_from_numpy(tree, device="cpu")["stages"][0][0]
    x = normal(np.random.default_rng(0), (2, 64, jcfg.d_model))
    xj, xt = both(x, "float32")
    kind = jcfg.resolved_stages[0][0]
    want = _hlo_flops(lambda p, v: jdec.apply_layer(p, v, jcfg, kind,
                                                    mode="train")[0],
                      jlayer, xj)
    got, _ = A.count_cost(tdec.apply_layer, tlayer, xt, tcfg, kind,
                          mode="train")
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=0.01)


# ---------------------------------------------------------------------------
# The fused ops' own counts
# ---------------------------------------------------------------------------

def _op_inputs(g):
    r = lambda *s: torch.randn(*s, generator=g)
    return {
        "attention": (lambda: (r(6, 10, 2, 8), r(6, 12, 2, 8), r(6, 12, 2, 8)),
                      dict(bias=r(3, 2, 10, 12), mask=torch.zeros(6, 12))),
        "triangle": (lambda: (r(2, 5, 7, 8), r(2, 5, 7, 8), torch.ones(2, 5, 7),
                              r(2, 6, 7, 8), r(8), r(8), r(8, 4), r(4),
                              r(2, 5, 6, 4), r(4)), {}),
        "opm": (lambda: (r(2, 3, 5, 4), r(2, 3, 6, 4), torch.ones(2, 3, 5),
                         torch.ones(2, 3, 6), r(16, 8), r(8)), {}),
    }


@pytest.mark.parametrize("op", ["attention", "triangle", "opm"])
def test_fused_op_flops_are_its_plain_versions_products(op):
    """A fused op's reported FLOPs equal the matrix products its plain
    version runs, and nothing inside it is counted again."""
    g = torch.Generator().manual_seed(0)
    args, kw = _op_inputs(g)[op]
    args = args()
    entry, cost, plain = {
        "attention": (ops.fused_attention, A.attention_cost,
                      lambda *a, bias, mask: ref.attention_ref(
                          *a, bias, mask, 8 ** -0.5)),
        "triangle": (ops.fused_triangle_mult, A.triangle_cost,
                     ref.triangle_mult_ref),
        "opm": (ops.fused_outer_product_mean, A.opm_cost,
                ref.outer_product_mean_ref),
    }[op]
    with A.counting() as c:
        entry(*args, **kw)
    want = cost(*args, **kw)
    assert (c.flops, c.hbm_bytes) == (want.flops, want.bytes)
    assert list(c.by_op) == [entry.__name__]
    plain_flops, _ = A.count_cost(plain, *args, **kw)
    assert plain_flops == want.flops


def test_counting_off_leaves_outputs_as_they_are():
    g = torch.Generator().manual_seed(1)
    x = torch.randn(4, 7, 16, generator=g)
    gamma, beta = torch.randn(16, generator=g), torch.randn(16, generator=g)
    assert A.active() is None
    off = ops.layer_norm(x, gamma, beta)
    with A.counting() as c:
        on = ops.layer_norm(x, gamma, beta)
    assert A.active() is None
    assert torch.equal(off, on)
    assert c.by_op == {"layer_norm": [1, 0.0, A.layer_norm_cost(
        x, gamma, beta).bytes]}


# ---------------------------------------------------------------------------
# The same count on either route
# ---------------------------------------------------------------------------

def _simulated_card(monkeypatch):
    """Every op routed as on the card, each CUDA wrapper replaced by its
    plain version with its outputs contiguous, as the wrappers allocate
    them; the Evoformer's branch choices (``_is_cuda``) left as they are,
    so both routes run the same branches. Returns the calls."""
    calls = []
    monkeypatch.setattr(ops, "_on_card", lambda t, op: True)
    fakes = {
        "layer_norm_cuda": lambda x, g, b, eps: ref.layer_norm_ref(x, g, b,
                                                                   eps),
        "bias_sigmoid_mul_cuda": ref.bias_sigmoid_mul_ref,
        "flash_attention_cuda": lambda *a, **kw: ref.attention_ref(*a[:6]),
        "flash_attention_bwd_cuda": lambda q, k, v, out, do, lse, b, m, s, nd:
            ref.attention_bwd_ref(q, k, v, do, out, lse, b, m, s),
        "fused_triangle_cuda": lambda *a, tile=0: ref.triangle_mult_ref(*a),
        "fused_opm_cuda": lambda *a, tile=0: ref.outer_product_mean_ref(*a),
        "bias_dropout_add_cuda": ref.bias_dropout_add_ref,
        "fused_softmax_cuda": ref.softmax_ref,
    }
    for name, fn in fakes.items():
        monkeypatch.setattr(ops, name, lambda *a, _f=fn, _n=name, **kw: (
            calls.append(_n), _contiguous(_f(*a, **kw)))[1])
    return calls


def _contiguous(out):
    if isinstance(out, tuple):
        return tuple(None if t is None else t.contiguous() for t in out)
    return out.contiguous()


def _smoke_counts():
    ff = FastFold(SMOKE, device="cpu")
    params = ff.init(seed=0)
    batch = next(protein_batches(batch=1, n_seq=3, n_res=6, seed=0)).as_dict()
    with A.counting() as fwd:
        ff.forward(params, batch)
    init, step = make_train_step(ff.loss_fn)
    with A.counting() as train:
        step(init(params), batch, torch.Generator().manual_seed(0))
    return (fwd.flops, fwd.hbm_bytes), (train.flops, train.hbm_bytes)


def test_count_is_the_same_on_the_card_route_and_the_plain_route(
        monkeypatch):
    cpu = _smoke_counts()
    calls = _simulated_card(monkeypatch)
    card = _smoke_counts()
    assert {"layer_norm_cuda", "flash_attention_cuda", "fused_triangle_cuda",
            "fused_opm_cuda", "flash_attention_bwd_cuda",
            "bias_dropout_add_cuda"} <= set(calls)
    assert card == cpu
    assert cpu[0][0] > 0 and cpu[1][0] > cpu[0][0]


def test_inference_mode_counts_what_composite_ops_run():
    """Under ``inference_mode`` einsum, matmul and linear reach the
    counter whole; they count as the products and copies they run, the
    same as with autograd on."""
    g = torch.Generator().manual_seed(2)
    q = torch.randn(2, 3, 5, 4, 8, generator=g)
    w = torch.randn(6, 8, generator=g)

    def f():
        s = torch.einsum("bgihd,bgjhd->bghij", q, q)
        return s, torch.nn.functional.linear(q, w), q @ w.T

    with_grad = A.count_cost(f)
    with torch.inference_mode():
        inference = A.count_cost(f)
    assert inference == with_grad
    assert with_grad[0] == 2 * 2 * 3 * 5 * 5 * 4 * 8 + 2 * 2 * (
        2 * 3 * 5 * 4 * 8 * 6)
