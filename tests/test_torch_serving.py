"""The port's serving engine against the JAX package's engine: the
counterparts of the reference's engine tests (``tests/test_serving.py``,
the engine tests of ``tests/test_resilience.py``, two of
``tests/test_obs.py`` and ``tests/test_exec_plan.py``'s mixed-plan test),
each scenario run by both engines on the same prompts, the same fully
randomised weights and the same fault specs, and held together: the same
terminal statuses, error types, attempts and ``fallback_chain``s, the same
event kinds and counts, the same decoder block plans and admission
answers; within each package the same exact-token properties the
reference asserts (a retry reproduces the fault-free tokens, mixed-plan
traffic equals a single-plan run, a traced run equals an untraced one).

Greedy tokens across the packages. Both engines compute in bf16, and the
two libraries round bf16 intermediates at different places (XLA's CPU
backend keeps some fused intermediates in fp32), so a logit can move by a
bf16 rounding between them. ``assert_same_greedy`` holds the tokens equal
up to the first step whose two candidates are a near tie: there the
reference's fp32 logits of the two tokens must lie within 2e-2·max(1,
max|logits|) of each other (the bf16 tolerance); after it the sequences
continue from different tokens and are not compared."""
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.exec.plan as jplan
import repro.memory.autochunk as jac
import repro.obs as jobs
import repro.resilience as jres
import repro.serving.engine as jeng
import repro_torch.exec.plan as tplan
import repro_torch.memory.autochunk as tac
import repro_torch.obs as tobs
import repro_torch.resilience as tres
import repro_torch.serving.engine as teng
from repro.configs import get_config as jget
from repro.models import decoder as jdec
from repro_torch.configs import get_config as tget
from repro_torch.models import decoder as tdec
from repro_torch.weights import (decoder_params_from_numpy,
                                 decoder_params_to_numpy, randomize_tree)

MAXSEQ = 24
PLEN = 6
TIE_TOL = 2e-2


def _np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(jnp.asarray(x, jnp.float32)),
                        tree)


@pytest.fixture(scope="module")
def sides():
    """Both packages behind one namespace each, on reduced qwen2-1.5b with
    every weight randomised (the reference's zero-initialised output
    projections would leave the tokens to the embeddings alone)."""
    jc = jget("qwen2-1.5b", reduced_variant=True)
    tree = randomize_tree(_np_tree(jdec.init_model(jax.random.PRNGKey(0),
                                                   jc)), 1)
    jax_side = types.SimpleNamespace(
        name="jax", cfg=jc, params=jax.tree.map(jnp.asarray, tree),
        ServingEngine=jeng.ServingEngine, preset=jplan.preset,
        FaultSpec=jres.FaultSpec, inject_faults=jres.inject_faults,
        RetryPolicy=jres.RetryPolicy, errors=jres, obs=jobs,
        check_decoder_admission=jac.check_decoder_admission,
        plan_decoder_blocks=jac.plan_decoder_blocks)
    torch_side = types.SimpleNamespace(
        name="torch", cfg=tget("qwen2-1.5b", reduced_variant=True),
        params=decoder_params_from_numpy(tree, device="cpu"),
        ServingEngine=functools.partial(teng.ServingEngine, device="cpu"),
        preset=tplan.preset,
        FaultSpec=tres.FaultSpec, inject_faults=tres.inject_faults,
        RetryPolicy=tres.RetryPolicy, errors=tres, obs=tobs,
        check_decoder_admission=tac.check_decoder_admission,
        plan_decoder_blocks=tac.plan_decoder_blocks)
    return jax_side, torch_side


def make_prompts(n, seed=0, vocab=500):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(PLEN,)) for _ in range(n)]


def run_engine(side, prompts, *, n_slots=2, max_new=3, plans=None,
               retry=None, max_seq=MAXSEQ, **engine_kw):
    eng = side.ServingEngine(side.params, side.cfg, n_slots=n_slots,
                             max_seq=max_seq, **engine_kw)
    reqs = [eng.submit(p, max_new_tokens=max_new,
                       plan=plans[i] if plans else None, retry=retry)
            for i, p in enumerate(prompts)]
    eng.run()
    return eng, reqs


def _ref_logits(sides, tokens):
    """The reference's fp32 logits after ``tokens``."""
    jax_side = sides[0]
    out = jdec.model_forward(jax_side.params,
                             jnp.asarray(tokens, jnp.int32)[None],
                             jax_side.cfg, mode="train", remat=False,
                             compute_dtype=jnp.float32)
    return np.asarray(out["logits"][0, -1])


def assert_same_greedy(sides, prompt, got, want):
    """``got`` (the port's greedy tokens) equals ``want`` (the reference's)
    up to the first step that is a near tie of the two candidates under the
    reference's fp32 logits; returns the number of tokens compared."""
    n = min(len(got), len(want))
    for i in range(n):
        if got[i] != want[i]:
            logits = _ref_logits(sides, list(prompt) + list(want[:i]))
            gap = float(logits[want[i]] - logits[got[i]])
            limit = TIE_TOL * max(1.0, float(np.abs(logits).max()))
            assert abs(gap) <= limit, (
                f"token {i}: port {got[i]} vs reference {want[i]}, fp32 "
                f"logit gap {gap:.4g} > {limit:.4g} (not a bf16 near tie)")
            return i
    assert len(got) == len(want)
    return n


def _plan_dicts(chain):
    return [p.to_dict() for p in chain]


def _outcome(r):
    return (r.uid, r.status, r.done, len(r.generated), r.attempts,
            None if r.error is None else type(r.error).__name__,
            _plan_dicts(r.fallback_chain))


def assert_same_outcomes(sides, prompts, ref_reqs, port_reqs):
    assert [_outcome(r) for r in port_reqs] == [_outcome(r) for r in ref_reqs]
    for p, rr, pr in zip(prompts, ref_reqs, port_reqs):
        if rr.status == "done":
            assert_same_greedy(sides, p, pr.generated, rr.generated)


def _ref_cache_np(eng):
    return [np.asarray(jnp.asarray(x, jnp.float32))
            for x in jax.tree.leaves(eng.cache)]


def _port_cache_np(eng):
    return jax.tree.leaves(decoder_params_to_numpy({"stages": eng.cache}))


# ---------------------------------------------------------------------------
# tests/test_serving.py
# ---------------------------------------------------------------------------

def _seq_greedy(side, prompt, n):
    """Sequential greedy decoding with ``model_forward`` in train mode (bf16,
    the engine's dtype), one full forward a token: the reference's oracle
    of its engine tests, here run in the port's package."""
    toks = list(prompt)
    outs = []
    for _ in range(n):
        if side.name == "jax":
            logits = jdec.model_forward(side.params,
                                        jnp.asarray(toks, jnp.int32)[None],
                                        side.cfg, mode="train",
                                        remat=False)["logits"]
            nxt = int(jnp.argmax(logits[0, -1]))
        else:
            logits = tdec.model_forward(side.params,
                                        torch.as_tensor(toks)[None],
                                        side.cfg)["logits"]
            nxt = int(torch.argmax(logits[0, -1]))
        outs.append(nxt)
        toks.append(nxt)
    return outs


def test_engine_matches_sequential_greedy(sides):
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, size=(6 + i,)) for i in range(5)]
    runs = {}
    for side in sides:
        eng = side.ServingEngine(side.params, side.cfg, n_slots=3, max_seq=48)
        reqs = [eng.submit(p, max_new_tokens=5) for p in prompts]
        finished = eng.run()
        assert len(finished) == 5
        if side.name == "torch":
            by_uid = {r.uid: r for r in finished}
            for i, prompt in enumerate(prompts[:3]):
                assert by_uid[i].generated == _seq_greedy(side, prompt, 5)
        runs[side.name] = reqs
    assert_same_outcomes(sides, prompts, runs["jax"], runs["torch"])


def test_engine_more_requests_than_slots(sides):
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 512, size=(4,)) for _ in range(6)]
    runs = {}
    for side in sides:
        eng = side.ServingEngine(side.params, side.cfg, n_slots=2, max_seq=32)
        reqs = [eng.submit(p, max_new_tokens=3) for p in prompts]
        finished = eng.run()
        assert len(finished) == 6
        assert all(len(r.generated) == 3 for r in finished)
        runs[side.name] = ([r.uid for r in finished], reqs)
    assert runs["torch"][0] == runs["jax"][0]     # the same finishing order
    assert_same_outcomes(sides, prompts, runs["jax"][1], runs["torch"][1])


def test_engine_rejects_overlength_prompt(sides):
    prompt = np.random.default_rng(3).integers(0, 512, size=(16,))
    for side in sides:
        eng = side.ServingEngine(side.params, side.cfg, n_slots=1, max_seq=16)
        with pytest.raises(ValueError, match="max_seq"):
            eng.submit(np.zeros((17,), np.int32))
        req = eng.submit(prompt, max_new_tokens=8)
        finished = eng.run()
        assert finished == [req] and req.done
        assert len(req.generated) == 1


def test_engine_forces_done_at_max_seq_and_never_clamps(sides, monkeypatch):
    """A slot reaching max_seq is force-finished; the tokens up to the cap
    match unbounded sequential greedy decoding. Every decode write of the
    port lands on a row inside its cache (the reference's
    ``dynamic_update_slice`` would clamp one past the end; the port's index
    assignment would raise): the engine never reaches the clamp."""
    rows = []
    scatter = tdec._scatter_one

    def recording(cache, new, r):
        rows.append((int(r.max()), cache.shape[1]))
        return scatter(cache, new, r)

    monkeypatch.setattr(tdec, "_scatter_one", recording)
    max_seq, plen = 12, 8
    prompt = np.random.default_rng(4).integers(0, 512, size=(plen,))
    runs = {}
    for side in sides:
        eng = side.ServingEngine(side.params, side.cfg, n_slots=2,
                                 max_seq=max_seq)
        req = eng.submit(prompt, max_new_tokens=50)
        finished = eng.run()
        assert finished == [req] and req.done
        assert len(req.generated) == max_seq - plen + 1
        if side.name == "torch":
            assert req.generated == _seq_greedy(side, prompt,
                                                len(req.generated))
        runs[side.name] = [req]
    assert rows and all(r < n for r, n in rows)
    assert max(r for r, _ in rows) == max_seq - 1     # the last row, no further
    assert_same_outcomes(sides, [prompt], runs["jax"], runs["torch"])


def test_engine_eos_stops_early(sides):
    prompt = np.random.default_rng(2).integers(0, 512, size=(6,))
    for side in sides:
        eos = _seq_greedy(side, prompt, 2)[1]
        eng = side.ServingEngine(side.params, side.cfg, n_slots=1, max_seq=32)
        eng.submit(prompt, max_new_tokens=10, eos_id=int(eos))
        finished = eng.run()
        assert finished[0].generated[-1] == eos
        assert len(finished[0].generated) <= 2


# ---------------------------------------------------------------------------
# tests/test_resilience.py, the engine under failure
# ---------------------------------------------------------------------------

BUDGETS = [1, 1 << 20, 3 << 20, 5 << 20, 6 << 20, 8 << 20, 1 << 30, 1 << 34]


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "gemma3-27b",
                                  "musicgen-medium", "qwen1.5-32b",
                                  "deepseek-moe-16b", "deepseek-v2-236b",
                                  "hymba-1.5b", "xlstm-125m"])
@pytest.mark.parametrize("reduced", [True, False])
def test_block_plans_and_admission_equal_the_reference(arch, reduced):
    jc = jget(arch, reduced_variant=reduced)
    tc = tget(arch, reduced_variant=reduced)
    for int8 in (False, True):
        jc_, tc_ = (dataclasses.replace(c, kv_cache_int8=int8)
                    for c in (jc, tc))
        for n_slots, max_seq in ((2, 24), (4, 512), (8, 4096)):
            scale = 1 if reduced else 1 << 10
            for budget in BUDGETS:
                budget *= scale
                kw = dict(n_slots=n_slots, max_seq=max_seq,
                          budget_bytes=budget)
                jcfg, jp = jac.plan_decoder_blocks(jc_, **kw)
                tcfg, tp = tac.plan_decoder_blocks(tc_, **kw)
                assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
                assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
                for seq_len in (None, 1, 6, max_seq, 2 * max_seq):
                    assert dataclasses.asdict(tac.check_decoder_admission(
                        tc_, seq_len=seq_len, **kw)) == dataclasses.asdict(
                        jac.check_decoder_admission(jc_, seq_len=seq_len,
                                                    **kw))


FAMILIES = ["deepseek-moe-16b", "deepseek-v2-236b", "hymba-1.5b",
            "xlstm-125m"]


def _family_sides(arch, seed=0):
    """Both packages on reduced ``arch``, every weight randomised."""
    jc = jget(arch, reduced_variant=True)
    tree = randomize_tree(_np_tree(jdec.init_model(jax.random.PRNGKey(seed),
                                                   jc)), seed + 1)
    return (types.SimpleNamespace(
                name="jax", cfg=jc, params=jax.tree.map(jnp.asarray, tree),
                ServingEngine=jeng.ServingEngine, preset=jplan.preset),
            types.SimpleNamespace(
                name="torch", cfg=tget(arch, reduced_variant=True),
                params=decoder_params_from_numpy(tree, device="cpu"),
                ServingEngine=functools.partial(teng.ServingEngine,
                                                device="cpu"),
                preset=tplan.preset))


@pytest.mark.parametrize("arch", FAMILIES)
def test_engine_serves_each_decoder_family(arch):
    """Both engines serve five requests on two slots of reduced ``arch``
    (the MoE, MLA, hymba and xLSTM kinds), the fourth an oracle-plan
    canary, so a decode step runs two plan groups and commits each
    group's rows of every cache and recurrent state. The outcomes are the
    same, the greedy tokens the same up to a bf16 near tie, each package's
    mixed-plan tokens equal its single-plan run, and the port's first
    request equals sequential greedy decoding (a train-mode recompute a
    token) up to a bf16 near tie: MLA decodes in its absorbed form, which
    rounds apart from the materialised recompute."""
    sides = _family_sides(arch)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 500, size=(6 + (i % 3),)) for i in range(5)]
    runs = {}
    for side in sides:
        plans = [side.preset("oracle") if i == 3 else None
                 for i in range(len(prompts))]
        _, mixed = run_engine(side, prompts, max_new=4, plans=plans)
        _, single = run_engine(side, prompts, max_new=4)
        assert [r.status for r in mixed] == ["done"] * len(prompts)
        assert [r.generated for r in mixed] == [r.generated for r in single]
        if side.name == "torch":
            assert_same_greedy(sides, prompts[0], mixed[0].generated,
                               _seq_greedy(side, prompts[0], 4))
        runs[side.name] = mixed
    assert_same_outcomes(sides, prompts, runs["jax"], runs["torch"])


def test_engine_fails_where_the_window_exceeds_max_seq():
    """ROADMAP.md R7: reduced hymba-1.5b (window 16) at max_seq 12. The
    prefill's rolling cache holds 16 rows, the slot 12: the reference's
    slot copy raises there, and so does the port's, naming both."""
    prompt = np.random.default_rng(6).integers(0, 500, size=(6,))
    for side in _family_sides("hymba-1.5b"):
        assert side.cfg.sliding_window == 16
        eng = side.ServingEngine(side.params, side.cfg, n_slots=2,
                                 max_seq=12)
        eng.submit(prompt, max_new_tokens=2)
        match = ("sliding window of 16 tokens exceeds max_seq=12"
                 if side.name == "torch" else "Incompatible shapes")
        with pytest.raises(ValueError, match=match):
            eng.run()


def test_planner_budget_defaults_to_the_device():
    cfg = tget("qwen2-1.5b", reduced_variant=True)
    from repro_torch.device import CPU_HBM_BYTES
    _, plan = tac.plan_decoder_blocks(cfg, n_slots=2, max_seq=24)
    assert plan.budget_bytes == CPU_HBM_BYTES
    chk = tac.check_decoder_admission(cfg, n_slots=2, max_seq=24,
                                      device="cpu")
    assert chk.budget_bytes == CPU_HBM_BYTES and chk.fits


def test_admission_query_api(sides):
    for side in sides:
        cfg = side.cfg
        ok = side.check_decoder_admission(cfg, n_slots=2, max_seq=MAXSEQ,
                                          seq_len=PLEN, budget_bytes=1 << 34)
        assert ok.fits and 0 < ok.est_bytes <= 1 << 34
        tiny = side.check_decoder_admission(cfg, n_slots=2, max_seq=MAXSEQ,
                                            seq_len=PLEN, budget_bytes=1)
        assert not tiny.fits and tiny.est_bytes == ok.est_bytes
        longer = side.check_decoder_admission(cfg, n_slots=2, max_seq=MAXSEQ,
                                              seq_len=MAXSEQ,
                                              budget_bytes=1 << 34)
        assert longer.est_bytes > ok.est_bytes
        assert "fits=False" in tiny.describe()


def test_submit_rejects_overbudget_plan(sides):
    for side in sides:
        eng = side.ServingEngine(side.params, side.cfg, n_slots=2,
                                 max_seq=MAXSEQ)
        starved = eng.plan.with_memory(hbm_budget=1)
        with pytest.raises(side.errors.AdmissionError, match="HBM"):
            eng.submit(np.zeros((PLEN,), np.int32), plan=starved)
        assert eng.pending == []


def test_bounded_pending_queue_backpressure(sides):
    for side in sides:
        eng = side.ServingEngine(side.params, side.cfg, n_slots=1,
                                 max_seq=MAXSEQ, max_pending=2)
        eng.submit(np.zeros((PLEN,), np.int32))
        eng.submit(np.zeros((PLEN,), np.int32))
        with pytest.raises(side.errors.AdmissionError, match="backpressure"):
            eng.submit(np.zeros((PLEN,), np.int32))
        assert len(eng.pending) == 2


def test_run_fails_never_admissible_instead_of_livelock(sides):
    outcomes = []
    for side in sides:
        eng = side.ServingEngine(side.params, side.cfg, n_slots=2,
                                 max_seq=MAXSEQ, admission_control=False)
        starved = eng.plan.with_memory(hbm_budget=1)
        bad = eng.submit(np.zeros((PLEN,), np.int32), plan=starved)
        good = eng.submit(np.zeros((PLEN,), np.int32), max_new_tokens=2)
        finished = eng.run()
        assert {r.uid for r in finished} == {bad.uid, good.uid}
        assert good.status == "done" and good.done
        assert bad.status == "failed"
        assert isinstance(bad.error, side.errors.AdmissionError)
        assert "never be admitted" in str(bad.error)
        outcomes.append([_outcome(r) for r in finished])
    assert outcomes[0] == outcomes[1]


def test_deadline_expires_active_request(sides):
    runs = {}
    for side in sides:
        eng = side.ServingEngine(side.params, side.cfg, n_slots=1,
                                 max_seq=MAXSEQ)
        req = eng.submit(make_prompts(1)[0], max_new_tokens=50, deadline=2)
        eng.run()
        assert req.status == "failed" and not req.done
        assert isinstance(req.error, side.errors.DeadlineExceeded)
        assert isinstance(req.error, TimeoutError)
        assert 0 < len(req.generated) < 50
        runs[side.name] = [req]
    assert _outcome(runs["torch"][0]) == _outcome(runs["jax"][0])


def test_deadline_expires_queued_request(sides):
    runs = {}
    for side in sides:
        eng = side.ServingEngine(side.params, side.cfg, n_slots=1,
                                 max_seq=MAXSEQ)
        hog = eng.submit(make_prompts(1)[0], max_new_tokens=8)
        starved = eng.submit(make_prompts(1, seed=1)[0], max_new_tokens=2,
                             deadline=2)
        eng.run()
        assert hog.status == "done" and len(hog.generated) == 8
        assert starved.status == "failed"
        assert isinstance(starved.error, side.errors.DeadlineExceeded)
        assert "queued" in str(starved.error)
        runs[side.name] = [hog, starved]
    assert_same_outcomes(sides, make_prompts(1) + make_prompts(1, seed=1),
                         runs["jax"], runs["torch"])


def _fault_case(name, side):
    """(fault specs, run_engine keywords) of a named scenario."""
    fs = side.FaultSpec
    retry = side.RetryPolicy(max_attempts=3, backoff=1.0)
    nonfinite_retry = side.RetryPolicy(
        max_attempts=3, backoff=1.0,
        retryable=lambda e: isinstance(e, side.errors.NonFiniteFault))
    start = [side.preset("default")]
    return {
        "transient_retried": ([fs("transient", "decode", uid=0, times=1)],
                              dict(n_slots=1, max_new=3, retry=retry)),
        "transient_no_policy": ([fs("transient", "decode", uid=0, times=1)],
                                dict(n_slots=1)),
        "nonfinite_quarantine": ([fs("nonfinite", "decode", slot=1, step=2,
                                     times=1)], dict(max_new=4)),
        "nonfinite_retried": ([fs("nonfinite", "decode", uid=0, times=1)],
                              dict(n_slots=1, max_new=4,
                                   retry=nonfinite_retry)),
        "oom_ladder": ([fs("oom", "decode", uid=0, times=None,
                           pred=lambda ctx: ctx.plan.kernels.enabled)],
                       dict(n_slots=1, max_new=3, plans=start)),
        "oom_prefill_once": ([fs("oom", "prefill", uid=0, times=1)],
                             dict(n_slots=1)),
        "oom_exhausted": ([fs("oom", "decode", uid=0, times=None)],
                          dict(n_slots=1, plans=start)),
        "empty_scope": ([], dict(max_new=3)),
    }[name]


N_PROMPTS = {"nonfinite_quarantine": 2, "empty_scope": 2}


@pytest.mark.parametrize("case", ["transient_retried", "transient_no_policy",
                                  "nonfinite_quarantine", "nonfinite_retried",
                                  "oom_ladder", "oom_prefill_once",
                                  "oom_exhausted", "empty_scope"])
def test_fault_scenarios_match_the_reference(sides, case):
    """Each engine fault test of the reference, run by both engines: the
    same faults fire, with the same outcomes; within each package a
    completed request reproduces its fault-free tokens exactly, and the
    surviving slot of a quarantine keeps its fault-free cache rows."""
    prompts = make_prompts(N_PROMPTS.get(case, 1))
    runs = {}
    for side in sides:
        specs, kw = _fault_case(case, side)
        clean_eng, clean = run_engine(side, prompts, **kw)
        with side.inject_faults(*specs) as inj:
            eng, reqs = run_engine(side, prompts, **kw)
        for r, c in zip(reqs, clean):
            if r.status == "done":
                assert r.generated == c.generated
        if case == "nonfinite_quarantine":
            assert reqs[1].status == "failed" and reqs[0].status == "done"
            get = _ref_cache_np if side.name == "jax" else _port_cache_np
            for a, b in zip(get(clean_eng), get(eng)):
                # slot 0's rows (each stage's leaves stack its layers first)
                np.testing.assert_array_equal(a[:, 0], b[:, 0])
        if case == "empty_scope":
            assert inj.total_fired == 0
            get = _ref_cache_np if side.name == "jax" else _port_cache_np
            for a, b in zip(get(clean_eng), get(eng)):
                np.testing.assert_array_equal(a, b)
        runs[side.name] = (dict(inj.counts), reqs)
    assert runs["torch"][0] == runs["jax"][0]
    assert_same_outcomes(sides, prompts, runs["jax"][1], runs["torch"][1])


def _random_specs(side, rng):
    specs = []
    for _ in range(int(rng.integers(1, 4))):
        fault = str(rng.choice(["oom", "nonfinite", "transient", "timeout"]))
        site = "prefill" if rng.random() < 0.25 else "decode"
        specs.append(side.FaultSpec(
            fault, site,
            step=int(rng.integers(1, 8)) if rng.random() < 0.7 else None,
            slot=int(rng.integers(0, 2)) if (site == "decode"
                                             and rng.random() < 0.5) else None,
            times=1))
    return specs


N_CHAOS_SEEDS = 10


def test_chaos_sweep_matches_the_reference(sides):
    """Mixed-plan requests under randomized fault schedules: in each
    package every request ends done or typed-failed, a completed request
    reproduces the fault-free tokens exactly, and fired faults reconcile;
    across the packages the same faults fire with the same outcomes."""
    prompts = make_prompts(4, seed=99)
    runs = {}
    for side in sides:
        plans = [None, side.preset("oracle"), None, side.preset("oracle")]
        pol = side.RetryPolicy(
            max_attempts=3, backoff=1.0,
            retryable=lambda e, s=side: isinstance(e, s.errors.InjectedFault))
        _, base = run_engine(side, prompts, max_new=3, plans=plans, retry=pol)
        want = {r.uid: list(r.generated) for r in base}
        per_seed = []
        for seed in range(N_CHAOS_SEEDS):
            rng = np.random.default_rng(seed)
            with side.inject_faults(*_random_specs(side, rng),
                                    seed=seed) as inj:
                eng, reqs = run_engine(side, prompts, max_new=3, plans=plans,
                                       retry=pol)
            assert all(r is None for r in eng.slot_req)
            assert not np.asarray(eng.lengths).any()
            for r in reqs:
                assert r.status in ("done", "failed")
                if r.status == "done":
                    assert r.generated == want[r.uid], (seed, r.uid)
            assert inj.total_fired == len(inj.events)
            per_seed.append((dict(inj.counts), [_outcome(r) for r in reqs]))
        runs[side.name] = (base, per_seed)
    assert runs["torch"][1] == runs["jax"][1]
    assert_same_outcomes(sides, prompts, runs["jax"][0], runs["torch"][0])


# ---------------------------------------------------------------------------
# tests/test_obs.py and tests/test_exec_plan.py
# ---------------------------------------------------------------------------

def test_unscoped_engine_run_is_bit_identical(sides):
    torch_side = sides[1]
    prompts = make_prompts(3)
    eng_a, reqs_a = run_engine(torch_side, prompts, max_new=3)
    with tobs.use_tracer() as tr:
        eng_b, reqs_b = run_engine(torch_side, prompts, max_new=3)
    assert len(tr.events) > 0
    for a, b in zip(reqs_a, reqs_b):
        assert a.generated == b.generated and b.status == "done"
    for a, b in zip(_port_cache_np(eng_a), _port_cache_np(eng_b)):
        np.testing.assert_array_equal(a, b)


def _event_counts(events):
    counts = {}
    for e in events:
        key = (e["kind"], e["name"])
        counts[key] = counts.get(key, 0) + 1
    return counts


def test_engine_lifecycle_stream_matches_the_reference(sides):
    """The port's event stream validates, reconciles and aggregates as the
    reference's does, with the same event kinds and the same counts of
    each (kind, name)."""
    streams = {}
    for side in sides:
        with side.obs.use_tracer() as tr:
            run_engine(side, make_prompts(4), max_new=3)
        events = tr.events_resolved()
        assert not side.obs.validate_events(events)
        assert not side.obs.reconcile(events)
        agg = side.obs.aggregate(events)
        assert agg["requests"]["phases"]["queued"] == 4
        assert agg["requests"]["phases"]["done"] == 4
        assert agg["counters"]["tokens"] == 12.0
        assert agg["meta"]["param_count"] > 0
        assert {"prefill", "decode", "engine.step", "engine.run"} <= \
            set(agg["spans"])
        eff = side.obs.hardware_efficiency(agg)
        assert set(eff) == {"decode", "prefill"}
        text = side.obs.render_report(events)
        assert "exactly one terminal state" in text
        streams[side.name] = (events, agg)
    assert (_event_counts(streams["torch"][0])
            == _event_counts(streams["jax"][0]))
    tmeta, jmeta = streams["torch"][1]["meta"], streams["jax"][1]["meta"]
    for k in ("param_count", "param_bytes", "cache_row_bytes", "n_slots",
              "max_seq", "model"):
        assert tmeta[k] == jmeta[k], k


def test_serving_engine_mixed_plan_traffic(sides):
    """A middle request on the oracle-leg canary plan runs in the same
    engine (two decode groups a step) with the single-plan run's greedy
    tokens; and the port's tokens are the reference's."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, size=(5 + i,)) for i in range(3)]
    runs = {}
    for side in sides:
        eng_ref = side.ServingEngine(side.params, side.cfg, n_slots=3,
                                     max_seq=32)
        want = [eng_ref.submit(p, max_new_tokens=4) for p in prompts]
        eng_ref.run()
        eng = side.ServingEngine(side.params, side.cfg, n_slots=3,
                                 max_seq=32)
        canary = side.preset("oracle")
        with side.obs.use_tracer() as tr:
            got = [eng.submit(p, max_new_tokens=4,
                              plan=canary if i == 1 else None)
                   for i, p in enumerate(prompts)]
            eng.run()
        assert got[1].plan == canary
        decode_keys = {e["key"] for e in tr.events
                       if e["kind"] == "jit_entry" and e["name"] == "decode"}
        assert len(decode_keys) == 2
        for w, g in zip(want, got):
            assert w.generated == g.generated
        runs[side.name] = got
    assert_same_outcomes(sides, prompts, runs["jax"], runs["torch"])


@pytest.mark.parametrize("device", [None, "meta"])
def test_engine_refuses_parameters_off_its_device(device):
    """The engine runs on the card unless asked for the CPU, and moves
    nothing: CPU parameters without ``device="cpu"`` raise (no card: the
    port's ``resolve_device`` error; a card: the parameters lie elsewhere),
    as do parameters that lie off an explicit device."""
    cfg = tget("qwen2-1.5b", reduced_variant=True)
    params = tdec.init_model(torch.Generator().manual_seed(0), cfg)
    want = (RuntimeError if device is None and not torch.cuda.is_available()
            else ValueError)
    with pytest.raises(want):
        teng.ServingEngine(params, cfg, n_slots=1, max_seq=16, device=device)


def test_mixed_plan_decode_commits_only_each_groups_rows(monkeypatch):
    """The second group's call must not see the first group's writes in
    its own rows, nor leave its writes in the first group's: with a decode
    that marks every row it returns by its plan, each slot's committed rows
    carry its own plan's mark."""
    side_cfg = tget("qwen2-1.5b", reduced_variant=True)
    params = tdec.init_model(torch.Generator().manual_seed(0), side_cfg)
    marks = {tplan.preset("default"): 1.0, tplan.preset("oracle"): 2.0}
    decode = teng._decode_step

    def marking(params, toks, cache, lengths, *, cfg, plan):
        out, finite = decode(params, toks, cache, lengths, cfg=cfg, plan=plan)
        for stage in out["cache"]:
            for layer in stage:
                for leaf in layer.values():
                    leaf[:, -1] = marks[plan]
        return out, finite

    monkeypatch.setattr(teng, "_decode_step", marking)
    eng = teng.ServingEngine(params, side_cfg, n_slots=3, max_seq=16,
                             device="cpu")
    prompts = make_prompts(3)
    for i, p in enumerate(prompts):
        eng.submit(p, max_new_tokens=4,
                   plan=tplan.preset("oracle") if i == 1 else None)
    eng.step()                                    # admit, then one decode
    for stage in eng.cache:
        for layer in stage:
            for leaf in layer.values():
                assert leaf[0, -1].unique().tolist() == [1.0]
                assert leaf[1, -1].unique().tolist() == [2.0]
                assert leaf[2, -1].unique().tolist() == [1.0]


def test_serve_launcher_runs_on_the_cpu_when_asked(capsys):
    """``python -m repro_torch.launch.serve --reduced --device cpu`` serves
    its requests to the end; without ``--device`` it takes the card."""
    from repro_torch.launch import serve

    serve.main(["--arch", "qwen2-1.5b", "--reduced", "--device", "cpu",
                "--requests", "3", "--max-new", "2", "--max-seq", "32"])
    assert "3 requests, 6 tokens" in capsys.readouterr().out
