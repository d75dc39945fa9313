"""Device and host time of one call on the card, for ``chip_smoke.py`` and
``scripts/torch_profile_serve.py``. Nothing on the main path uses it.

* ``device_ms``: the device time of each CUDA kernel a call launches, from
  ``torch.profiler``, over 20 calls, each after a write that evicts the
  50 MB L2 cache (or none);
* ``cold_device_ms``: the same without a flush, the calls cycling through
  copies of their inputs that together hold 200 MB or more, 4x the L2. A
  written flush leaves dirty lines that the timed call writes back, so a
  memory-bound call pays for more than its own bytes; cycling copies
  charges each call its own reads and, in the steady state, the
  write-back of one earlier call's output: the bytes its bound counts;
* ``host_us``: the host time of one call, the device left to run behind.
"""
from __future__ import annotations

import statistics
import time
from collections import defaultdict

import torch

COLD_BYTES = 200 << 20


def device_ms(fn, flush, reps: int = 20) -> dict[str, float]:
    """Device time per call of each kernel ``fn`` launches: over ``reps``
    calls, each after ``flush.zero_()`` (none where ``flush`` is None), the
    median duration of each kernel (by name) times its launches per call
    (for a name launched for different work within a call, as the
    elementwise kernels of a composition are, that stands for their sum).
    The flush's own kernels are left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def tally(f):
        for _ in range(3):
            f()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if flush is not None:
                    flush.zero_()
                f()
            torch.cuda.synchronize()
        out = defaultdict(list)
        for evt in prof.profiler.kineto_results.events():
            if evt.device_type() == DeviceType.CUDA:
                out[evt.name()[:80]].append((evt.end_ns() - evt.start_ns()) / 1e6)
        return out

    flush_kernels = set(tally(lambda: None))
    return {k: statistics.median(ms) * len(ms) / reps
            for k, ms in tally(fn).items() if k not in flush_kernels}


def cold_device_ms(fn, make_args) -> tuple[float, int]:
    """The summed device time of ``fn(*args)`` on cold inputs: ``args``
    cycle through copies (``make_args()`` each) holding ``COLD_BYTES`` or
    more together. Returns (ms, copies)."""
    sets = [make_args()]
    size = sum(t.numel() * t.element_size() for t in sets[0]
               if isinstance(t, torch.Tensor))
    while len(sets) < max(2, -(-COLD_BYTES // max(size, 1))):
        sets.append(make_args())
    turn = iter(range(1 << 62))
    ms = sum(device_ms(lambda: fn(*sets[next(turn) % len(sets)]), None).values())
    return ms, len(sets)


def host_us(fn, calls: int = 50) -> float:
    """Host time of one call, the device left to run behind."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us
