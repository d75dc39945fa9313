"""Deterministic, seedable fault injection (the port's copy of the
reference's module).

``FaultInjector`` is scoped exactly like ``exec.plan.use_plan`` — a
contextvar entered with ``inject_faults(...)`` — so fault scopes nest,
restore on exit, and compose with plan scopes without touching either's
hashing. Sites call the module-level ``fire(site, **ctx)``, which is a
no-op (returns ``()``) when no injector is active: production code paths
carry zero overhead and zero behavior change outside a fault scope.

    from repro_torch.resilience import FaultSpec, inject_faults

    with inject_faults(FaultSpec("oom", "decode", uid=3, times=2),
                       FaultSpec("transient", "decode", p=0.1),
                       seed=1234) as inj:
        engine.run()
    assert inj.counts["OomFault"] == 2

Determinism contract: given the same specs, the same seed, and the same
sequence of ``fire`` calls (the engine's control flow is deterministic),
the same faults fire at the same events — tests never sleep and never
flake. Probabilistic specs (``p < 1``) draw from one seeded stream in call
order; everything else is pure predicate matching.

The default seed comes from ``REPRO_FAULT_SEED`` through the single
env-compat module (``exec/envcompat.fault_seed``), so CI legs can pin a
process-wide schedule while environment access stays confined there.
"""
from __future__ import annotations

import random
from contextlib import contextmanager
from contextvars import ContextVar
from dataclasses import dataclass, field
from typing import Any, Callable, Optional


# ---------------------------------------------------------------------------
# Typed faults
# ---------------------------------------------------------------------------


class InjectedFault(RuntimeError):
    """Base of the typed fault hierarchy. Instances carry the firing
    context (site / step / slot / uid) for reconciliation in tests."""

    def __init__(self, message: str = "", *, site: str = "?",
                 step: Optional[int] = None, slot: Optional[int] = None,
                 uid: Optional[int] = None):
        self.site, self.step, self.slot, self.uid = site, step, slot, uid
        super().__init__(
            message or f"{type(self).__name__} at {site!r} "
                       f"(step={step} slot={slot} uid={uid})")


class OomFault(InjectedFault):
    """Simulated RESOURCE_EXHAUSTED — routed to the graceful-degradation
    ladder (``ExecutionPlan.degrade``) by the serving engine."""


class NonFiniteFault(InjectedFault):
    """Non-finite values in a decode group's logits. When *injected*, the
    engine poisons the slot's KV rows with NaN so the in-trace guard
    catches it end to end; the same type is raised for organic NaNs."""


class StageTimeout(InjectedFault):
    """A pipeline stage exceeded its time budget (straggler)."""


class TransientDecodeFault(InjectedFault):
    """A transient, retryable decode failure (flaky interconnect, evicted
    host, preempted device) — the canonical RetryPolicy target."""


_FAULTS: dict[str, type[InjectedFault]] = {
    "oom": OomFault,
    "nonfinite": NonFiniteFault,
    "timeout": StageTimeout,
    "transient": TransientDecodeFault,
}

_SITES = ("prefill", "decode", "checkpoint.save")


def is_oom(err: BaseException) -> bool:
    """True for injected OOMs and for real accelerator OOMs. The string
    match keeps this module free of torch: ``torch.cuda.OutOfMemoryError``'s
    message says "CUDA out of memory", and the reference's XLA errors say
    RESOURCE_EXHAUSTED."""
    if isinstance(err, OomFault):
        return True
    msg = str(err)
    return "RESOURCE_EXHAUSTED" in msg or "out of memory" in msg.lower()


# ---------------------------------------------------------------------------
# Specs + injector
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FireContext:
    """What a site knows when it fires — the argument of ``FaultSpec.pred``."""

    site: str
    step: Optional[int] = None
    slot: Optional[int] = None
    uid: Optional[int] = None
    attempt: int = 0
    plan: Any = None


@dataclass(frozen=True)
class FaultSpec:
    """One fault schedule entry: fire ``fault`` at ``site`` whenever every
    given predicate matches. ``None`` predicates match everything.

    ``after`` skips the first N eligible events, ``times`` caps total
    firings (``None`` = unlimited), ``p`` fires probabilistically from the
    injector's seeded stream, and ``pred`` is an arbitrary
    ``FireContext -> bool`` (e.g. fire only while the request's plan still
    has kernels enabled, so the degradation ladder terminates)."""

    fault: str
    site: str
    step: Optional[int] = None
    slot: Optional[int] = None
    uid: Optional[int] = None
    after: int = 0
    times: Optional[int] = 1
    p: float = 1.0
    pred: Optional[Callable[[FireContext], bool]] = None

    def __post_init__(self):
        if self.fault not in _FAULTS:
            raise ValueError(
                f"FaultSpec.fault={self.fault!r}: not in {sorted(_FAULTS)}")
        if self.site not in _SITES:
            raise ValueError(
                f"FaultSpec.site={self.site!r}: not in {_SITES}")
        if not 0.0 <= self.p <= 1.0:
            raise ValueError(f"FaultSpec.p={self.p!r}: not in [0, 1]")


@dataclass
class _SpecState:
    eligible: int = 0
    fired: int = 0


class FaultInjector:
    """Evaluates FaultSpecs at fire sites; counts everything it does.

    ``counts`` maps fault class name -> total fired; ``events`` is the
    ordered log of fired faults (for reconciliation asserts). One injector
    is single-use state — build a fresh one per scenario."""

    def __init__(self, specs=(), *, seed: Optional[int] = None):
        if seed is None:
            from repro_torch.exec import envcompat

            seed = envcompat.fault_seed() or 0
        self.seed = seed
        self.specs = tuple(specs)
        for s in self.specs:
            if not isinstance(s, FaultSpec):
                raise TypeError(f"expected FaultSpec, got {s!r}")
        self._rng = random.Random(seed)
        self._state = [_SpecState() for _ in self.specs]
        self.events: list[InjectedFault] = []

    @property
    def counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for f in self.events:
            name = type(f).__name__
            out[name] = out.get(name, 0) + 1
        return out

    @property
    def total_fired(self) -> int:
        return len(self.events)

    def fire(self, site: str, *, step: Optional[int] = None,
             slot: Optional[int] = None, uid: Optional[int] = None,
             attempt: int = 0, plan: Any = None) -> tuple[InjectedFault, ...]:
        """Faults fired for this event, in spec order (possibly empty)."""
        ctx = FireContext(site=site, step=step, slot=slot, uid=uid,
                          attempt=attempt, plan=plan)
        fired: list[InjectedFault] = []
        for spec, st in zip(self.specs, self._state):
            if spec.site != site:
                continue
            if spec.step is not None and spec.step != step:
                continue
            if spec.slot is not None and spec.slot != slot:
                continue
            if spec.uid is not None and spec.uid != uid:
                continue
            if spec.pred is not None and not spec.pred(ctx):
                continue
            st.eligible += 1
            if st.eligible <= spec.after:
                continue
            if spec.times is not None and st.fired >= spec.times:
                continue
            if spec.p < 1.0 and self._rng.random() >= spec.p:
                continue
            st.fired += 1
            fault = _FAULTS[spec.fault](site=site, step=step, slot=slot,
                                        uid=uid)
            fired.append(fault)
            self.events.append(fault)
        return tuple(fired)


# ---------------------------------------------------------------------------
# Scoping (mirrors exec.plan.use_plan)
# ---------------------------------------------------------------------------

_INJECTOR: ContextVar[Optional[FaultInjector]] = ContextVar(
    "repro_fault_injector", default=None)


def current_injector() -> Optional[FaultInjector]:
    """The innermost ``inject_faults`` scope's injector, else None."""
    return _INJECTOR.get()


def fire(site: str, **ctx) -> tuple[InjectedFault, ...]:
    """Module-level fire hook for instrumented sites: ``()`` outside any
    fault scope (the production fast path — one contextvar read)."""
    inj = _INJECTOR.get()
    if inj is None:
        return ()
    return inj.fire(site, **ctx)


@contextmanager
def inject_faults(*specs, seed: Optional[int] = None):
    """Scope a FaultInjector (re-entrant, exception-safe restore). Pass
    FaultSpecs (+ optional seed), or a single pre-built FaultInjector."""
    if len(specs) == 1 and isinstance(specs[0], FaultInjector):
        inj = specs[0]
    else:
        inj = FaultInjector(specs, seed=seed)
    token = _INJECTOR.set(inj)
    try:
        yield inj
    finally:
        _INJECTOR.reset(token)
