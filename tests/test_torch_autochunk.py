"""The port's AutoChunk planner (``repro_torch.memory.autochunk``) against
the reference's (``repro.memory.autochunk``), and the forward it steers.

The reference's planner tests, ported: no chunk where the unchunked plan
fits, never over a feasible budget, ``fits=False`` when nothing fits,
tighter budgets never chunk less, DAP relieves the model, chunks divide
their extents, knobs set by hand stay, ``auto_chunk=False`` opts out, and
the forward resolves its chunks. On the materialized branches the port's
byte terms and plans equal the reference's over a grid of shapes and
budgets; on the kernel branches they are the port's own (the module's
docstring). The port's forward under each forced knob stays within 1e-4 of
its unchunked forward and within 1e-3 of the reference's forward under the
same knobs, fp32, every weight randomised."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.alphafold import FULL as J_FULL
from repro.configs.alphafold import MINI as J_MINI
from repro.configs.alphafold import SMOKE as J_SMOKE
from repro.core.alphafold import alphafold_forward as j_alphafold_forward
from repro.core.alphafold import init_alphafold
from repro.exec import plan as jplan
from repro.memory import autochunk as jac
from repro_torch.configs import FULL, MINI, SMOKE
from repro_torch.core.alphafold import alphafold_forward, planned_evoformer
from repro_torch.data import protein_batches
from repro_torch.device import CPU_HBM_BYTES, hbm_budget_bytes
from repro_torch.exec import FastFold
from repro_torch.exec import plan as tplan
from repro_torch.memory import autochunk as ac
from repro_torch.weights import params_from_numpy, randomize_tree
from torch_parity import FORWARD_TOL, MODULE_TOL, assert_close

# Port and reference configs of the same widths, by name.
CONFIGS = {"SMOKE": (SMOKE, J_SMOKE), "MINI": (MINI, J_MINI),
           "FULL": (FULL, J_FULL)}
BUDGET = 16 << 30
KNOBS = ("inference_chunk", "opm_chunk", "attn_kv_tile", "tri_k_tile",
         "opm_s_tile")


def _knobs(plan) -> tuple:
    return tuple(getattr(plan, k) for k in KNOBS)


def _total(cfg, **kw):
    return sum(ac.evoformer_peak_bytes(cfg, **kw).values())


# ---------------------------------------------------------------------------
# The reference's planner tests, on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("name", ["SMOKE", "MINI"])
def test_no_chunk_when_unchunked_fits(name, fused):
    evo = CONFIGS[name][0].evoformer
    plan = ac.plan_evoformer_chunks(evo, batch=1, n_seq=8, n_res=96,
                                    budget_bytes=BUDGET, fused=fused)
    assert plan == ac.ChunkPlan(0, 0, 0, plan.est_bytes, BUDGET, True)
    assert plan.est_bytes <= BUDGET


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("frac", [0.9, 0.5, 0.25, 0.1])
@pytest.mark.parametrize("name", ["SMOKE", "MINI"])
def test_never_exceeds_budget_when_feasible(name, frac, fused):
    evo = CONFIGS[name][0].evoformer
    kw = dict(batch=1, n_seq=16, n_res=128, fused=fused)
    base = ac.plan_evoformer_chunks(evo, budget_bytes=BUDGET, **kw)
    budget = int(base.est_bytes * frac)
    plan = ac.plan_evoformer_chunks(evo, budget_bytes=budget, **kw)
    if plan.fits:
        assert plan.est_bytes <= budget
    else:
        # No candidate beats the budget: the plan of least bytes.
        assert plan.est_bytes > budget
        assert all(e >= plan.est_bytes for _, e, _ in ac._search_space(
            evo, 1, 16, 128, 1, fused, fused, fused, torch.bfloat16)[0])


@pytest.mark.parametrize("name", ["SMOKE", "MINI"])
def test_infeasible_budget_flags_not_fits(name):
    evo = CONFIGS[name][0].evoformer
    plan = ac.plan_evoformer_chunks(evo, batch=1, n_seq=16, n_res=128,
                                    budget_bytes=1)
    assert not plan.fits and plan.est_bytes > 1


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("name", ["SMOKE", "MINI"])
def test_tighter_budget_never_less_chunking(name, fused):
    evo = CONFIGS[name][0].evoformer
    kw = dict(batch=1, n_seq=16, n_res=128, fused=fused)
    base = ac.plan_evoformer_chunks(evo, budget_bytes=BUDGET, **kw)
    tight = ac.plan_evoformer_chunks(evo, budget_bytes=base.est_bytes // 2,
                                     **kw)
    assert tight.est_bytes <= base.est_bytes
    assert _knobs(tight) != (0, 0, 0, 0, 0)


@pytest.mark.parametrize("fused", [True, False])
def test_dap_relieves_memory_pressure(fused):
    kw = dict(batch=1, n_seq=512, n_res=2048, fused=fused)
    assert (_total(FULL.evoformer, dap=8, **kw)
            < _total(FULL.evoformer, dap=1, **kw))


def test_attention_bytes_linear_on_the_kernel_quadratic_materialized():
    """The kernel branch (K5) holds no scores: linear in r and no KV-tile
    term; the materialized branch's scores grow with r²."""
    kw = dict(dtype_bytes=4)
    f_1k = ac.attention_transient_bytes(8, 4, 1024, 32, fused=True, **kw)
    f_2k = ac.attention_transient_bytes(8, 4, 2048, 32, fused=True, **kw)
    m_1k = ac.attention_transient_bytes(8, 4, 1024, 32, fused=False, **kw)
    m_2k = ac.attention_transient_bytes(8, 4, 2048, 32, fused=False, **kw)
    assert f_2k == 2 * f_1k
    assert m_2k / m_1k > 3.5
    assert f_1k * 4 < m_1k
    assert ac.attention_transient_bytes(8, 4, 1024, 32, kv_tile=128,
                                        fused=True, **kw) == f_1k


@pytest.mark.parametrize("name", ["SMOKE", "MINI"])
def test_kernel_tiles_are_never_picked_where_they_move_nothing(name):
    """On the kernel branches no tile (and not ``opm_chunk``) changes a
    term, so no plan picks one, however tight; a tile set by hand is still
    pinned. On the materialized OPM ``opm_chunk`` does move its term."""
    evo = CONFIGS[name][0].evoformer
    kw = dict(batch=1, n_seq=16, n_res=256)
    for budget in (BUDGET, 1 << 24, 1):
        plan = ac.plan_evoformer_chunks(evo, budget_bytes=budget, **kw)
        assert _knobs(plan)[1:] == (0,) * 4
    pinned = dataclasses.replace(evo, tri_k_tile=16)
    assert ac.plan_evoformer_chunks(pinned, budget_bytes=BUDGET,
                                    **kw).tri_k_tile == 16
    base = _total(evo, **kw)
    for knob in ("attn_kv_tile", "tri_k_tile", "opm_s_tile", "opm_chunk"):
        assert _total(evo, **{knob: 16}, **kw) == base, knob
    assert (_total(evo, fused=False, opm_chunk=16, **kw)
            < _total(evo, fused=False, **kw))


@pytest.mark.parametrize("name", ["SMOKE", "MINI"])
def test_chunk_knobs_divide_their_extents(name):
    """A chunk that does not divide its extent runs unchunked, so the plan
    hands out dividing chunks only and models the rest as unchunked."""
    evo = CONFIGS[name][0].evoformer
    kw = dict(batch=1, n_seq=24, n_res=100, fused=False)
    base = ac.plan_evoformer_chunks(evo, budget_bytes=BUDGET, **kw)
    budget = max(base.est_bytes // 2, 1)
    plan = ac.plan_evoformer_chunks(evo, budget_bytes=budget, **kw)
    if plan.inference_chunk:
        assert 24 % plan.inference_chunk == 0 or \
            100 % plan.inference_chunk == 0
    if plan.opm_chunk:
        assert 100 % plan.opm_chunk == 0
    if plan.fits:
        assert plan.est_bytes <= budget
    assert _total(evo, inference_chunk=7, **kw) == _total(evo, **kw)


def test_hand_set_knobs_are_pinned():
    cfg = dataclasses.replace(SMOKE.evoformer, inference_chunk=3)
    plan = ac.plan_evoformer_chunks(cfg, batch=1, n_seq=16, n_res=64,
                                    budget_bytes=BUDGET)
    assert plan.inference_chunk == 3
    out = ac.apply_plan(cfg, ac.ChunkPlan(8, 16, 128, 0, 0, True))
    assert out.inference_chunk == 3
    assert out.opm_chunk == 16 and out.attn_kv_tile == 128


def test_resolve_respects_auto_chunk_flag():
    evo = SMOKE.evoformer
    cfg = dataclasses.replace(evo, auto_chunk=False)
    assert ac.resolve_evoformer_config(cfg, batch=1, n_seq=8, n_res=64,
                                       budget_bytes=1) is cfg
    cfg2 = ac.resolve_evoformer_config(evo, batch=1, n_seq=8, n_res=64)
    assert _knobs(cfg2) == (0,) * 5
    tight = ac.resolve_evoformer_config(evo, batch=1, n_seq=8, n_res=64,
                                        budget_bytes=1)
    assert _knobs(tight) != (0,) * 5


def test_cpu_budget_is_a_stated_constant():
    assert hbm_budget_bytes("cpu") == hbm_budget_bytes() == CPU_HBM_BYTES
    with tplan.use_plan(tplan.ExecutionPlan().with_memory(hbm_budget=1)):
        plan = ac.evoformer_chunk_plan(SMOKE.evoformer, batch=1, n_seq=8,
                                       n_res=64, device="cpu")
    assert plan.budget_bytes == 1 and not plan.fits


@pytest.fixture(scope="module")
def smoke_tree():
    init = jax.jit(init_alphafold, static_argnums=1)
    tree = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), J_SMOKE))
    return randomize_tree(tree, 31)


def _batch(n_seq=8, n_res=24, seed=0, **kw):
    return next(protein_batches(batch=1, n_seq=n_seq, n_res=n_res, seed=seed,
                                **kw)).as_dict()


def test_alphafold_forward_resolves_chunks(smoke_tree):
    """A tight ``hbm_budget`` through ``alphafold_forward`` makes the
    forward chunk, and its outputs stay those of the free-budget run; the
    planner got the budget less what lies outside the block."""
    cfg = dataclasses.replace(SMOKE, compute_dtype=torch.float32)
    params = params_from_numpy(smoke_tree, device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in _batch().items()}
    free = alphafold_forward(params, batch, cfg, n_recycle=0)
    evo, chunks, budget = planned_evoformer(cfg, (1, 8, 24), device="cpu")
    assert chunks.fits and _knobs(chunks) == (0,) * 5 and evo == cfg.evoformer
    outside = sum(ac.outside_block_bytes(cfg.evoformer, batch=1, n_seq=8,
                                         n_res=24,
                                         dtype=torch.float32).values())
    assert budget == CPU_HBM_BYTES - outside
    tight = ac.modeled_evoformer_peak(
        cfg.evoformer, batch=1, n_seq=8, n_res=24, dtype=torch.float32) // 2
    evo, chunks, budget = planned_evoformer(cfg, (1, 8, 24), device="cpu",
                                            hbm_budget=tight + outside)
    assert budget == tight and _knobs(chunks) != (0,) * 5
    assert _knobs(evo) == _knobs(chunks)
    chunked = alphafold_forward(params, batch, cfg, n_recycle=0,
                                hbm_budget=tight + outside)
    for k in ("coords", "pair", "msa"):
        assert_close(chunked[k], free[k], MODULE_TOL["float32"], k)


# ---------------------------------------------------------------------------
# The materialized branches: the reference's terms and plans
# ---------------------------------------------------------------------------

GRID = [(n_res, n_seq) for n_res in (24, 100, 256, 1024, 2048)
        for n_seq in (8, 128)]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_materialized_terms_and_plans_equal_the_reference(name):
    t_evo, j_evo = CONFIGS[name][0].evoformer, CONFIGS[name][1].evoformer
    for n_res, n_seq in GRID:
        kw = dict(batch=1, n_seq=n_seq, n_res=n_res, fused=False)
        for knobs in ({}, {"inference_chunk": 4}, {"opm_chunk": 8},
                      {"inference_chunk": n_res // 2, "opm_chunk": 7}):
            assert (ac.evoformer_peak_bytes(t_evo, **kw, **knobs)
                    == jac.evoformer_peak_bytes(j_evo, **kw, **knobs))
        base = jac.plan_evoformer_chunks(j_evo, budget_bytes=1 << 50, **kw)
        for frac in (1.0, 0.6, 0.3, 0.1, 0.01, 0.0):
            budget = int(base.est_bytes * frac)
            got = ac.plan_evoformer_chunks(t_evo, budget_bytes=budget, **kw)
            want = jac.plan_evoformer_chunks(j_evo, budget_bytes=budget, **kw)
            assert dataclasses.astuple(got) == dataclasses.astuple(want), (
                n_res, n_seq, frac)


@pytest.mark.parametrize("field", ["inference_chunk", "attn_kv_tile",
                                   "auto_chunk"])
def test_memory_policy_apply_matches_the_reference(field):
    value = False if field == "auto_chunk" else 4
    got = tplan.MemoryPolicy(**{field: value}).apply(SMOKE.evoformer)
    want = jplan.MemoryPolicy(**{field: value}).apply(J_SMOKE.evoformer)
    for k in KNOBS + ("auto_chunk",):
        assert getattr(got, k) == getattr(want, k), k
    assert tplan.MemoryPolicy().apply(SMOKE.evoformer) is SMOKE.evoformer


# ---------------------------------------------------------------------------
# The forward under forced knobs
# ---------------------------------------------------------------------------

FORCED = [{"inference_chunk": 2}, {"opm_chunk": 4}, {"attn_kv_tile": 8},
          {"tri_k_tile": 16}, {"opm_s_tile": 16},
          {"inference_chunk": 2, "opm_chunk": 4, "attn_kv_tile": 8,
           "tri_k_tile": 16, "opm_s_tile": 16}]
FORCED_PLANS = {"default": {}, "oracle": {"enabled": False}}


@pytest.fixture(scope="module")
def forced_setup(smoke_tree):
    """SMOKE in fp32 at r = 40 (every tile below r), one MSA row masked,
    and the unchunked forward of the port under each plan."""
    cfg = dataclasses.replace(SMOKE, compute_dtype=torch.float32)
    batch = _batch(n_seq=6, n_res=40, seed=4, n_real=34)
    ff = FastFold(cfg, device="cpu")
    params = params_from_numpy(smoke_tree, device="cpu")
    base = {}
    for name, kern in FORCED_PLANS.items():
        plan = tplan.ExecutionPlan(kernels=tplan.KernelPolicy(**kern))
        base[name] = ff.forward(params, batch, n_recycle=0,
                                plan=plan.with_memory(auto_chunk=False))
    return cfg, batch, ff, params, base


@pytest.mark.parametrize("plan_name", list(FORCED_PLANS))
@pytest.mark.parametrize("knobs", FORCED,
                         ids=lambda k: "+".join(f"{a}={b}" for a, b in k.items()))
def test_forced_knobs_leave_the_forward_unchanged(knobs, plan_name,
                                                  forced_setup, smoke_tree):
    cfg, batch, ff, params, base = forced_setup
    kern = FORCED_PLANS[plan_name]
    plan = tplan.ExecutionPlan(kernels=tplan.KernelPolicy(**kern),
                               memory=tplan.MemoryPolicy(**knobs))
    with tplan.use_plan(plan):
        evo, _, _ = planned_evoformer(cfg, (1, 6, 40), device="cpu")
    for k, v in knobs.items():
        assert getattr(evo, k) == v
    got = ff.forward(params, batch, n_recycle=0, plan=plan)
    j_cfg = dataclasses.replace(J_SMOKE, compute_dtype=jnp.float32)
    j_plan = jplan.ExecutionPlan.from_json(plan.to_json())
    j_params = jax.tree.map(jnp.asarray, smoke_tree)
    with jplan.use_plan(j_plan):
        want = jax.jit(lambda p, b: j_alphafold_forward(
            p, b, j_cfg, n_recycle=0))(
            j_params, {k: jnp.asarray(v) for k, v in batch.items()})
    for k in ("coords", "msa_logits", "distogram_logits", "msa", "pair"):
        assert_close(got[k], base[plan_name][k], MODULE_TOL["float32"], k)
        assert_close(got[k], want[k], FORWARD_TOL["float32"], k)
