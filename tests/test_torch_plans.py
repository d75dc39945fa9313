"""The port's ExecutionPlan (``repro_torch.exec.plan``) against the
reference's, and the Evoformer's materialized branches module by module.

Plan parity: every preset serialises to the reference's JSON, the policies
validate alike, ``use_plan`` nests and restores, the environment selects
the reference's plan, and ``FastFold`` raises on what the port does not
serve yet. Branches: under ``KernelPolicy(attention="oracle")`` the four
attention sites run the scores-materialized form (``ops.fused_softmax``,
never ``ops.fused_attention``); under ``preset("triangle-oracle")`` both
triangle updates and the outer-product-mean (whole and j-chunked) run
their materialized form; each against the reference's own module under the
same plan, on fully randomised weights, fp32 within 1e-4 and bf16 within
2e-2 (torch_parity)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.alphafold import SMOKE as J_SMOKE
from repro.core import evoformer as jevo
from repro.exec import envcompat as j_envcompat
from repro.exec import plan as jplan
from repro_torch.configs import SMOKE as T_SMOKE
from repro_torch.core import dist as tdist
from repro_torch.data import protein_batches
from repro_torch.exec import FastFold
from repro_torch.exec import plan as tplan
from repro_torch.kernels import ops
from repro_torch.weights import params_from_numpy, randomize_tree
from test_torch_modules import _masks, _run_site
from torch_parity import MODULE_TOL, assert_close, both, normal

DT = ["float32", "bfloat16"]
B, S, R, N_REAL = 2, 6, 12, 9


# ---------------------------------------------------------------------------
# The plan object
# ---------------------------------------------------------------------------

def _degrade_chain(plan):
    out = [plan]
    while (plan := plan.degrade()) is not None:
        out.append(plan)
    return out


@pytest.mark.parametrize("name", sorted(jplan.PRESETS))
def test_presets_serialise_as_the_reference(name):
    assert set(tplan.PRESETS) == set(jplan.PRESETS)
    got, want = tplan.preset(name), jplan.preset(name)
    assert got.to_json() == want.to_json()
    assert got.describe() == want.describe()
    assert [p.to_json() for p in _degrade_chain(got)] == \
        [p.to_json() for p in _degrade_chain(want)]
    back = tplan.ExecutionPlan.from_json(want.to_json())
    assert back == got and hash(back) == hash(got)


def test_policies_validate_as_the_reference():
    plan = tplan.ExecutionPlan().with_kernels(attention="oracle", attn_bwd="scan")
    ref = jplan.ExecutionPlan().with_kernels(attention="oracle", attn_bwd="scan")
    assert plan.to_json() == ref.to_json()
    for kw in ({"softmax": "cuda"}, {"attn_bwd": "flash"}):
        for mod in (tplan, jplan):
            with pytest.raises(ValueError):
                mod.KernelPolicy(**kw)
    with pytest.raises(ValueError):
        tplan.ParallelPolicy(backend="nccl")
    with pytest.raises(KeyError):
        tplan.preset("fastest")


def test_use_plan_nests_and_restores(monkeypatch):
    monkeypatch.delenv("REPRO_PLAN", raising=False)
    outer = tplan.preset("oracle")
    inner = tplan.ExecutionPlan(kernels=tplan.KernelPolicy(attention="oracle"))
    assert tplan.current_plan() == tplan.preset("default")
    with tplan.use_plan(outer):
        assert tplan.current_plan() is outer
        assert ops.kernel_leg("softmax") == "oracle"
        with tplan.use_plan(inner) as p:
            assert p is inner and tplan.current_plan() is inner
            assert ops.kernel_leg("attention") == "oracle"
            assert ops.kernel_leg("softmax") == "auto"
        assert tplan.current_plan() is outer
    assert tplan.current_plan() == tplan.preset("default")
    with pytest.raises(TypeError):
        with tplan.use_plan("oracle"):
            pass


@pytest.mark.parametrize("env", [
    {"REPRO_PLAN": "oracle"},
    {"REPRO_PLAN": "interpret", "REPRO_FORCE_TRIANGLE_ORACLE": "1"},
    {"REPRO_DISABLE_KERNELS": "1", "REPRO_FORCE_SCAN_ATTN_BWD": "1"},
    {"REPRO_PALLAS_INTERPRET": "1"},
])
def test_environment_selects_the_reference_plan(env, monkeypatch):
    for k in ("REPRO_PLAN", "REPRO_DISABLE_KERNELS", "REPRO_PALLAS_INTERPRET",
              "REPRO_FORCE_TRIANGLE_ORACLE", "REPRO_FORCE_SCAN_ATTN_BWD"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = tplan.current_plan()
    assert got.to_json() == j_envcompat.plan_from_env().to_json()
    assert FastFold(T_SMOKE, device="cpu").plan == got


@pytest.mark.parametrize("plan,item", [
    (tplan.ExecutionPlan().with_parallel(backend="shard_map"), "item 3"),
])
def test_fastfold_raises_on_what_the_port_does_not_serve(plan, item,
                                                        tmp_path):
    """ROADMAP Queue 1 item 3 (DAP) is served: a "shard_map" plan builds
    the process-group backend on the default group where one exists (and
    raises where none does); the backend raises only for what it cannot
    take: a whole model (it runs the Evoformer on shards its caller made;
    the whole model is "gspmd") and a group size that does not divide s or
    r. The whole model under "gspmd" on one rank is the local forward."""
    with pytest.raises(RuntimeError, match="process group"):
        plan.parallel.make_dist()
    with pytest.raises(RuntimeError, match="process group"):
        FastFold(T_SMOKE, device="cpu", plan=plan)
    tdist.form_group(0, 1, str(tmp_path / "store"))
    try:
        d = plan.parallel.make_dist()
        assert type(d) is tdist.ProcessGroupDist
        assert d.group is None and d.axis_size == 1 and d.rank == 0
        ff = FastFold(T_SMOKE, device="cpu", plan=plan)
        batch = next(protein_batches(batch=1, n_seq=3, n_res=6,
                                     seed=0)).as_dict()
        params = ff.init(0)
        with pytest.raises(ValueError, match="gspmd"):
            ff.forward(params, batch)
        with pytest.raises(ValueError, match=r"n_seq=3, n_res=6"):
            tdist.check_layout(4, n_seq=3, n_res=6)
        whole = plan.with_parallel(backend="gspmd")
        assert type(whole.parallel.make_dist()) is tdist.WholeModelDist
        got = ff.forward(params, batch, plan=whole)
        want = ff.forward(params, batch, plan=tplan.ExecutionPlan())
        for k in ("coords", "msa_logits", "distogram_logits"):
            assert torch.equal(got[k], want[k]), k
    finally:
        tdist.tdist.destroy_process_group()


def _reference_forward(tree, batch, plan, n_recycle=None):
    """The reference's fp32 SMOKE forward under the reference's copy of
    ``plan`` (its JSON form)."""
    from repro.core.alphafold import alphafold_forward

    j_cfg = dataclasses.replace(J_SMOKE, compute_dtype=jnp.float32)
    with jplan.use_plan(jplan.ExecutionPlan.from_json(plan.to_json())):
        fn = jax.jit(lambda p, b: alphafold_forward(p, b, j_cfg,
                                                    n_recycle=n_recycle))
        return fn(jax.tree.map(jnp.asarray, tree),
                  {k: jnp.asarray(v) for k, v in batch.items()})


# The MemoryPolicy requests the port refused before it served AutoChunk:
# each now runs, on the reference's numbers.
MEMORY_PLANS = {
    "inference_chunk": tplan.ExecutionPlan().with_memory(inference_chunk=4),
    "hbm_budget": tplan.ExecutionPlan().with_memory(hbm_budget=1 << 30),
    "auto_chunk": tplan.ExecutionPlan().with_memory(auto_chunk=True),
}


@pytest.mark.parametrize("name", list(MEMORY_PLANS))
def test_fastfold_runs_memory_plans_as_the_reference(name):
    plan = MEMORY_PLANS[name]
    tree = randomize_tree(_jax_smoke_tree(), 43)
    ff = FastFold(dataclasses.replace(T_SMOKE, compute_dtype=torch.float32),
                  device="cpu", plan=plan)
    assert ff.plan is plan
    batch = next(protein_batches(batch=1, n_seq=4, n_res=8, seed=5)).as_dict()
    got = ff.forward(params_from_numpy(tree, device="cpu"), batch)
    want = _reference_forward(tree, batch, plan)
    for k in ("coords", "msa_logits", "distogram_logits", "pair"):
        assert_close(got[k], want[k], 1e-3, k)


def test_fastfold_accepts_opm_chunk_and_async():
    plan = (tplan.ExecutionPlan().with_memory(opm_chunk=4, auto_chunk=False)
            .with_async(overlap_windows=False))
    assert FastFold(T_SMOKE, device="cpu", plan=plan).plan is plan


@pytest.mark.parametrize("start", ["default", "triangle-oracle"])
def test_every_degrade_rung_runs(start):
    """Every rung of ``degrade()`` (the tightest chunk and tile knobs, then
    every op on its plain version) serves a SMOKE forward on the CPU, on
    the reference's numbers under the same rung."""
    tree = randomize_tree(_jax_smoke_tree(), 44)
    params = params_from_numpy(tree, device="cpu")
    ff = FastFold(dataclasses.replace(T_SMOKE, compute_dtype=torch.float32),
                  device="cpu")
    batch = next(protein_batches(batch=1, n_seq=4, n_res=16, seed=6,
                                 n_real=13)).as_dict()
    rungs = _degrade_chain(tplan.preset(start))
    assert len(rungs) == 3
    assert rungs[1].memory.inference_chunk == 1
    for rung in rungs:
        got = ff.forward(params, batch, n_recycle=0, plan=rung)
        want = _reference_forward(tree, batch, rung, n_recycle=0)
        for k in ("coords", "distogram_logits", "pair"):
            assert_close(got[k], want[k], 1e-3, f"{rung.describe()} {k}")


def test_forward_takes_rng_and_train():
    """``FastFold.forward(rng=, train=)``: ``train=False`` is the
    reference's forward; ``train=True`` without an rng builds the graph on
    the same numbers; with an rng it draws dropout masks."""
    tree = randomize_tree(_jax_smoke_tree(), 45)
    params = params_from_numpy(tree, device="cpu")
    ff = FastFold(dataclasses.replace(T_SMOKE, compute_dtype=torch.float32),
                  device="cpu", plan=tplan.preset("default"))
    batch = next(protein_batches(batch=1, n_seq=4, n_res=8, seed=7)).as_dict()
    for p in params["evoformer"][0]["msa_row"]["attn"]["wqkv"].values():
        p.requires_grad_(True)
    gen = torch.Generator().manual_seed(3)
    infer = ff.forward(params, batch, rng=gen, train=False)
    want = _reference_forward(tree, batch, tplan.preset("default"))
    for k in ("coords", "msa_logits", "distogram_logits", "pair"):
        assert_close(infer[k], want[k], 1e-3, k)
    assert not infer["pair"].requires_grad
    plain = ff.forward(params, batch, rng=None, train=True)
    assert plain["pair"].requires_grad
    for k in ("coords", "msa_logits", "distogram_logits", "pair"):
        torch.testing.assert_close(plain[k].detach(), infer[k],
                                   rtol=0, atol=0)
    dropped = ff.forward(params, batch, rng=gen, train=True)
    assert not torch.equal(dropped["pair"].detach(), infer["pair"])


def test_serve_takes_one_plan_per_request():
    ff = FastFold(dataclasses.replace(T_SMOKE, compute_dtype=torch.float32),
                  device="cpu", plan=tplan.preset("default"))
    params = params_from_numpy(randomize_tree(_jax_smoke_tree(), 41),
                               device="cpu")
    batch = next(protein_batches(batch=1, n_seq=4, n_res=8, seed=2)).as_dict()
    with pytest.raises(ValueError, match="2 batches but 1 plans"):
        ff.serve(params, [batch, batch], plans=[None])
    seen = []
    real = ops.fused_softmax
    try:
        ops.fused_softmax = lambda *a, **k: seen.append(1) or real(*a, **k)
        outs = ff.serve(params, [batch, batch],
                        plans=[None, tplan.preset("oracle")])
    finally:
        ops.fused_softmax = real
    # Only the oracle request materialized its scores: 4 sites x 2 blocks x
    # 2 passes.
    assert len(seen) == 4 * 2 * 2
    assert_close(outs[1]["coords"], outs[0]["coords"].numpy(), 1e-3, "coords")


def _jax_smoke_tree():
    from repro.core.alphafold import init_alphafold

    init = jax.jit(init_alphafold, static_argnums=1)
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), J_SMOKE))


# ---------------------------------------------------------------------------
# The materialized branches, module by module
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def block_params():
    init = jax.jit(jevo.init_evoformer_block, static_argnums=1)
    tree = jax.tree.map(np.asarray,
                        init(jax.random.PRNGKey(1), J_SMOKE.evoformer))
    tree = randomize_tree(tree, 17)
    return (jax.tree.map(jnp.asarray, tree),
            params_from_numpy({"x": tree}, device="cpu")["x"])


@pytest.fixture(scope="module")
def feats():
    rng = np.random.default_rng(9)
    evo = J_SMOKE.evoformer
    seq = np.ones((B, R), np.float32)
    seq[:, N_REAL:] = 0
    msa_mask = np.ones((B, S, R), np.float32)
    msa_mask[..., N_REAL:] = 0
    msa_mask[0, 3] = 0                    # one whole MSA row masked
    return {"msa": normal(rng, (B, S, R, evo.d_msa)),
            "pair": normal(rng, (B, R, R, evo.d_pair)),
            "seq_mask": seq, "msa_mask": msa_mask,
            "pair_mask": seq[:, :, None] * seq[:, None, :]}


ATTN_ORACLE = dict(attention="oracle")
BRANCHES = {
    # site: (KernelPolicy fields, opm_chunk, op the branch must call, op it
    # must not call)
    "msa_row": (ATTN_ORACLE, 0, "fused_softmax", "fused_attention"),
    "msa_col": (ATTN_ORACLE, 0, "fused_softmax", "fused_attention"),
    "tri_attn_start": (ATTN_ORACLE, 0, "fused_softmax", "fused_attention"),
    "tri_attn_end": (ATTN_ORACLE, 0, "fused_softmax", "fused_attention"),
    "tri_mult_out": (dict(triangle="oracle", opm="oracle"), 0,
                     "bias_sigmoid_mul", "fused_triangle_mult"),
    "tri_mult_in": (dict(triangle="oracle", opm="oracle"), 0,
                    "bias_sigmoid_mul", "fused_triangle_mult"),
    "opm": (dict(triangle="oracle", opm="oracle"), 0, None,
            "fused_outer_product_mean"),
    "opm_chunked": (dict(opm="oracle"), 4, None, "fused_outer_product_mean"),
}


@pytest.mark.parametrize("dtype", DT)
@pytest.mark.parametrize("branch", list(BRANCHES))
def test_materialized_branch_matches_reference(branch, dtype, block_params,
                                               feats, monkeypatch):
    legs, chunk, must, must_not = BRANCHES[branch]
    site = "opm" if branch.startswith("opm") else branch
    jcfg = dataclasses.replace(J_SMOKE.evoformer, opm_chunk=chunk)
    tcfg = dataclasses.replace(T_SMOKE.evoformer, opm_chunk=chunk)
    jp, tp = block_params
    msa_j, msa_t = both(feats["msa"], dtype)
    pair_j, pair_t = both(feats["pair"], dtype)
    mj, mt = _masks(feats)
    with jplan.use_plan(jplan.ExecutionPlan(kernels=jplan.KernelPolicy(**legs))):
        want = _run_site(site, jp, msa_j, pair_j, mj, jcfg, True)
    calls = {must: 0, must_not: 0}
    for name in filter(None, calls):
        real = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _r=real, _n=name, **k: (
            calls.__setitem__(_n, calls[_n] + 1), _r(*a, **k))[1])
    if branch == "opm_chunked":
        blocks = []
        real_einsum = torch.einsum
        monkeypatch.setattr(torch, "einsum", lambda eq, *a: (
            blocks.append(a[1].shape[2]) if eq == "bsic,bsjd->bijcd" else None,
            real_einsum(eq, *a))[1])
    with tplan.use_plan(tplan.ExecutionPlan(kernels=tplan.KernelPolicy(**legs))):
        got = _run_site(site, tp, msa_t, pair_t, mt, tcfg, False)
    assert got.dtype == msa_t.dtype or got.dtype == pair_t.dtype
    if must:
        assert calls[must] == 1, calls
    assert calls[must_not] == 0, calls
    if branch == "opm_chunked":
        assert blocks == [chunk] * (R // chunk)
    assert_close(got, want, MODULE_TOL[dtype], branch)
