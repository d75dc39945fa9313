"""The port's resilience package (``repro_torch.resilience``): the mirror of
the reference's FaultInjector and RetryPolicy tests in
``tests/test_resilience.py`` (scoping, predicates, seeded probabilistic
firing, spec validation, the environment's seed, ``is_oom``, retry), plus
the port against the reference: the same fault classes and sites, the same
firing pattern from the same seed, and ``is_oom`` on the message of
``torch.cuda.OutOfMemoryError``."""
import pytest
import torch

from repro.resilience import faults as jfaults
from repro.resilience import inject_faults as j_inject_faults
from repro.resilience import fire as j_fire
from repro_torch.resilience import (
    FaultInjector,
    FaultSpec,
    OomFault,
    RetryPolicy,
    StageTimeout,
    TransientDecodeFault,
    current_injector,
    fire,
    inject_faults,
    is_oom,
)
from repro_torch.resilience import faults as tfaults


# ---------------------------------------------------------------------------
# FaultInjector (tests/test_resilience.py)
# ---------------------------------------------------------------------------


def test_fire_is_noop_outside_scope():
    assert current_injector() is None
    assert fire("decode", step=1, slot=0) == ()


def test_injector_scoping_nested_and_exception_safe():
    outer_spec = FaultSpec("oom", "decode")
    inner_spec = FaultSpec("transient", "decode")
    with inject_faults(outer_spec, seed=0) as outer:
        assert current_injector() is outer
        with inject_faults(inner_spec, seed=0) as inner:
            assert current_injector() is inner
            (f,) = fire("decode", step=1)
            assert isinstance(f, TransientDecodeFault)
        assert current_injector() is outer
        with pytest.raises(RuntimeError, match="boom"):
            with inject_faults(inner_spec, seed=0):
                raise RuntimeError("boom")
        assert current_injector() is outer       # restored despite the raise
    assert current_injector() is None


def test_spec_predicates_step_slot_uid_after_times():
    spec = FaultSpec("oom", "decode", step=3, slot=1, uid=7, after=1, times=2)
    with inject_faults(spec, seed=0) as inj:
        assert fire("decode", step=2, slot=1, uid=7) == ()   # wrong step
        assert fire("decode", step=3, slot=0, uid=7) == ()   # wrong slot
        assert fire("decode", step=3, slot=1, uid=8) == ()   # wrong uid
        assert fire("prefill", step=3, slot=1, uid=7) == ()  # wrong site
        assert fire("decode", step=3, slot=1, uid=7) == ()   # after=1 skips
        f1 = fire("decode", step=3, slot=1, uid=7)
        f2 = fire("decode", step=3, slot=1, uid=7)
        f3 = fire("decode", step=3, slot=1, uid=7)           # times exhausted
        assert len(f1) == len(f2) == 1 and f3 == ()
        assert isinstance(f1[0], OomFault)
        assert f1[0].slot == 1 and f1[0].uid == 7 and f1[0].step == 3
        assert inj.counts == {"OomFault": 2} and inj.total_fired == 2


def test_spec_pred_callable_and_unlimited_times():
    spec = FaultSpec("transient", "decode", times=None,
                     pred=lambda ctx: ctx.attempt < 3)
    with inject_faults(spec, seed=0) as inj:
        assert len(fire("decode", attempt=1)) == 1
        assert len(fire("decode", attempt=2)) == 1
        assert fire("decode", attempt=3) == ()
        assert inj.total_fired == 2


def test_probabilistic_firing_is_seed_deterministic():
    spec = FaultSpec("transient", "decode", times=None, p=0.5)

    def pattern(seed):
        with inject_faults(spec, seed=seed):
            return [bool(fire("decode", step=i)) for i in range(40)]

    a, b = pattern(123), pattern(123)
    assert a == b                            # identical seed -> identical run
    assert any(a) and not all(a)             # p=0.5 actually both-sided
    assert pattern(124) != a                 # and the seed matters


def test_spec_validation():
    with pytest.raises(ValueError, match="fault"):
        FaultSpec("segfault", "decode")
    with pytest.raises(ValueError, match="site"):
        FaultSpec("oom", "everywhere")
    with pytest.raises(ValueError, match="p="):
        FaultSpec("oom", "decode", p=1.5)
    with pytest.raises(TypeError):
        FaultInjector(["oom"], seed=0)


def test_default_seed_comes_from_env(monkeypatch):
    monkeypatch.setenv("REPRO_FAULT_SEED", "123")
    spec = FaultSpec("transient", "decode", times=None, p=0.5)
    env_pattern = [bool(FaultInjector([spec]).fire("decode", step=0))
                   for _ in range(1)]
    inj = FaultInjector([spec])
    assert inj.seed == 123
    explicit = FaultInjector([spec], seed=123)
    got = [bool(inj.fire("decode", step=i)) for i in range(20)]
    want = [bool(explicit.fire("decode", step=i)) for i in range(20)]
    assert got == want and env_pattern is not None


def test_is_oom_covers_injected_and_runtime_strings():
    assert is_oom(OomFault(site="decode"))
    assert is_oom(RuntimeError("RESOURCE_EXHAUSTED: Out of memory on chip"))
    assert is_oom(RuntimeError("Allocator ran out of memory"))
    assert not is_oom(RuntimeError("shape mismatch"))
    assert not is_oom(TransientDecodeFault(site="decode"))


# ---------------------------------------------------------------------------
# RetryPolicy (tests/test_resilience.py)
# ---------------------------------------------------------------------------


def test_backoff_is_capped_exponential():
    pol = RetryPolicy(max_attempts=6, backoff=1.0, multiplier=2.0,
                      max_backoff=8.0)
    assert [pol.delay(a) for a in range(1, 6)] == [1.0, 2.0, 4.0, 8.0, 8.0]
    assert pol.delay_steps(3) == 4
    assert RetryPolicy(backoff=0.25).delay_steps(1) == 1   # never same-step


def test_jitter_is_bounded_and_deterministic():
    pol = RetryPolicy(backoff=4.0, jitter=0.5)
    d1, d2 = pol.delay(1, seed=7), pol.delay(1, seed=7)
    assert d1 == d2                                        # deterministic
    assert 2.0 <= d1 <= 6.0                                # within +/- 50%
    assert pol.delay(1, seed=8) != d1


def test_retryable_defaults_and_should_retry():
    pol = RetryPolicy(max_attempts=3)
    assert pol.should_retry(TransientDecodeFault(site="decode"), 1)
    assert pol.should_retry(StageTimeout(site="decode"), 2)
    assert not pol.should_retry(TransientDecodeFault(site="decode"), 3)
    assert not pol.should_retry(OomFault(site="decode"), 1)   # ladder's job
    assert not pol.should_retry(ValueError("bug"), 1)


def test_call_retries_with_recorded_backoff_then_succeeds():
    sleeps, calls = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise TransientDecodeFault(site="decode")
        return "ok"

    pol = RetryPolicy(max_attempts=3, backoff=1.0, multiplier=2.0)
    assert pol.call(flaky, sleep=sleeps.append) == "ok"
    assert len(calls) == 3 and sleeps == [1.0, 2.0]


def test_call_nonretryable_and_exhaustion_reraise():
    pol = RetryPolicy(max_attempts=2, backoff=1.0)
    with pytest.raises(ValueError):
        pol.call(lambda: (_ for _ in ()).throw(ValueError("no")),
                 sleep=lambda _: None)
    attempts = []

    def always_fails():
        attempts.append(1)
        raise StageTimeout(site="decode")

    with pytest.raises(StageTimeout):
        pol.call(always_fails, sleep=lambda _: None)


# ---------------------------------------------------------------------------
# The port against the reference
# ---------------------------------------------------------------------------


def test_fault_classes_and_sites_match_the_reference():
    assert tfaults._SITES == jfaults._SITES
    assert {k: v.__name__ for k, v in tfaults._FAULTS.items()} == {
        k: v.__name__ for k, v in jfaults._FAULTS.items()}
    for name, cls in tfaults._FAULTS.items():
        assert issubclass(cls, tfaults.InjectedFault)
        assert issubclass(cls, RuntimeError)


@pytest.mark.parametrize("seed", [0, 123])
def test_firing_pattern_matches_the_reference(seed):
    """The same specs and seed fire the same faults at the same events in
    both packages (one ``random.Random(seed)`` stream, drawn in call
    order)."""
    specs = [("transient", "decode", dict(times=None, p=0.3)),
             ("oom", "prefill", dict(times=3, after=2)),
             ("timeout", "checkpoint.save", dict(step=4))]

    def run(spec_cls, scope, fire_fn):
        with scope(*(spec_cls(f, s, **kw) for f, s, kw in specs), seed=seed):
            return [[type(x).__name__ for x in fire_fn(site, step=i)]
                    for i in range(30)
                    for site in ("decode", "prefill", "checkpoint.save")]

    port = run(FaultSpec, inject_faults, fire)
    ref = run(jfaults.FaultSpec, j_inject_faults, j_fire)
    assert port == ref
    assert any(port)


def test_is_oom_matches_a_cuda_out_of_memory_error():
    """``torch.cuda.OutOfMemoryError`` says "CUDA out of memory" (the
    caching allocator's message), which the string match takes."""
    err = torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB. GPU 0 has a total "
        "capacity of 79.19 GiB of which 1.10 GiB is free.")
    assert isinstance(err, RuntimeError)
    assert is_oom(err)
    assert not is_oom(torch.cuda.OutOfMemoryError("unrelated"))
