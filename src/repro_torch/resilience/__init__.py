"""Resilience layer: deterministic fault injection, retry policies, and the
typed failure vocabulary of the serving / training stack.

At production scale (the ROADMAP's millions-of-users folding service, and
ParaFold's large-scale prediction runs) the binding constraint is not peak
throughput but surviving stragglers, OOMs, and stage failures without losing
work. This package makes every failure path a first-class, deterministically
testable object:

  * ``faults``  — ``FaultInjector`` / ``FaultSpec`` / ``inject_faults``: a
    seedable, ``use_plan``-style scoped injector that fires typed faults at
    named sites on step/slot/uid predicates. No sleeps, no flakiness: the
    same specs + seed fire the same faults in the same order.
  * ``retry``   — ``RetryPolicy``: capped exponential backoff with optional
    deterministic jitter and a pluggable ``retryable`` predicate.
  * ``errors``  — the typed failure vocabulary shared by the serving engine
    and checkpointing (``AdmissionError``, ``DeadlineExceeded``,
    ``CorruptCheckpointError``).

Fault-site / retry / degradation matrix (how each fault at each site is
handled by the serving engine and checkpointing):

  site             fault                 handling
  ---------------  --------------------  -----------------------------------
  prefill          OomFault /            graceful-degradation ladder:
                   RESOURCE_EXHAUSTED    retry under ``ExecutionPlan
                                         .degrade()`` rungs (tighter
                                         MemoryPolicy chunks -> oracle
                                         kernel leg), fallback chain
                                         recorded on the Request; typed
                                         fail when the ladder is exhausted.
  prefill          TransientDecodeFault  ``submit(..., retry=RetryPolicy)``:
                   / StageTimeout        slot-safe requeue with capped
                                         exponential backoff (in engine
                                         steps), typed fail when attempts
                                         are exhausted or no policy is set.
  decode           OomFault /            degradation ladder (as above); the
                   RESOURCE_EXHAUSTED    slot is torn down through the same
                                         ``_release`` invariant and the
                                         request re-prefills from scratch
                                         (no lost or duplicated tokens).
  decode           TransientDecodeFault  retry policy (as above).
                   / StageTimeout
  decode           NonFiniteFault        the injector poisons the slot's KV
                                         rows with NaN; the engine's
                                         in-trace per-decode-group guard
                                         quarantines ONLY the offending
                                         slots (other slots' caches stay
                                         bit-identical); quarantined
                                         requests fail typed, or retry when
                                         the policy marks NonFiniteFault
                                         retryable (the re-prefill
                                         overwrites the poisoned rows).
  (any)            deadline              ``submit(..., deadline=N)``: the
                                         request fails ``DeadlineExceeded``
                                         after N engine steps, queued or
                                         active.
  checkpoint.save  any fault             simulates a writer crash mid-write:
                                         the temp file is truncated and the
                                         fault raised BEFORE the atomic
                                         publish — the previous checkpoint
                                         stays intact, ``latest_checkpoint``
                                         skips + GCs the debris.

Training-side, ``train/loop.py`` carries a non-finite gradient guard
(skip-step + counter) that is a bit-identical no-op on healthy steps —
see ``make_train_step(guard_nonfinite=...)``.

This package imports nothing of torch: scoping works before a device is
touched, and the injector is usable from launchers and subprocess scripts.
It is the port's copy of the reference's package. Every site above fires
in the port: ``prefill`` and ``decode`` in the LM serving engine
(``serving/engine.py``, ROADMAP.md Queue 1 item 5), ``checkpoint.save`` in
``train/checkpoint.py``.
"""
from repro_torch.resilience.errors import (  # noqa: F401
    AdmissionError,
    CorruptCheckpointError,
    DeadlineExceeded,
)
from repro_torch.resilience.faults import (  # noqa: F401
    FaultInjector,
    FaultSpec,
    InjectedFault,
    NonFiniteFault,
    OomFault,
    StageTimeout,
    TransientDecodeFault,
    current_injector,
    fire,
    inject_faults,
    is_oom,
)
from repro_torch.resilience.retry import RetryPolicy  # noqa: F401
