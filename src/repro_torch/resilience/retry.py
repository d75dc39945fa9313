"""RetryPolicy: capped exponential backoff with deterministic jitter.

One reusable policy object serves every retry consumer: the serving
engine's ``submit(..., retry=...)`` (which interprets delays as *engine
steps*, so tests never sleep), and direct ``policy.call(fn)`` wrapping for
host-side stages (checkpoint saves, feature-pipeline RPCs), where delays
are seconds through an injectable ``sleep``.
"""
from __future__ import annotations

import math
import random
import time
from dataclasses import dataclass, field
from typing import Callable


def default_retryable(err: BaseException) -> bool:
    """Transient-by-construction faults retry by default; everything else
    (OOM -> degradation ladder, non-finite -> quarantine, real bugs ->
    propagate) needs an explicit opt-in predicate."""
    from repro_torch.resilience.faults import StageTimeout, TransientDecodeFault

    return isinstance(err, (TransientDecodeFault, StageTimeout))


@dataclass(frozen=True)
class RetryPolicy:
    """``max_attempts`` counts total tries (1 = no retry). Delay before
    retry #k (after attempt k failed) is
    ``min(backoff * multiplier**(k-1), max_backoff)``, stretched by up to
    ``+/- jitter`` (a fraction), drawn deterministically from
    ``(seed, attempt)``."""

    max_attempts: int = 3
    backoff: float = 1.0
    multiplier: float = 2.0
    max_backoff: float = 30.0
    jitter: float = 0.0
    retryable: Callable[[BaseException], bool] = field(
        default=default_retryable)

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("RetryPolicy.max_attempts must be >= 1")
        if not 0.0 <= self.jitter < 1.0:
            raise ValueError("RetryPolicy.jitter must be in [0, 1)")

    def delay(self, attempt: int, *, seed: int = 0) -> float:
        """Backoff before retrying after (1-based) ``attempt`` failed."""
        d = min(self.backoff * self.multiplier ** max(attempt - 1, 0),
                self.max_backoff)
        if self.jitter:
            u = random.Random(f"{seed}:{attempt}").random()  # deterministic
            d *= 1.0 + self.jitter * (2.0 * u - 1.0)
        return max(d, 0.0)

    def delay_steps(self, attempt: int, *, seed: int = 0) -> int:
        """The delay quantized to engine steps (>= 1: a retry is never
        eligible in the same step it failed)."""
        return max(1, math.ceil(self.delay(attempt, seed=seed)))

    def should_retry(self, err: BaseException, attempt: int) -> bool:
        """True when (1-based) ``attempt`` failed with ``err`` and another
        try is allowed."""
        return attempt < self.max_attempts and bool(self.retryable(err))

    def call(self, fn: Callable, *args, sleep: Callable = time.sleep,
             seed: int = 0, **kw):
        """Run ``fn`` under this policy. Retryable failures back off via
        ``sleep`` (injectable — tests pass a recorder); the final failure
        re-raises the original error."""
        attempt = 0
        while True:
            attempt += 1
            try:
                return fn(*args, **kw)
            except Exception as err:
                if not self.should_retry(err, attempt):
                    raise
                sleep(self.delay(attempt, seed=seed))
