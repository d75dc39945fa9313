"""Typed failure vocabulary shared by serving and checkpointing.

These are the *expected* production failures — every handler in the stack
catches these types (or the ``InjectedFault`` hierarchy in ``faults.py``),
never bare ``Exception``: an unrecognized error is a bug and must
propagate. The port's copy of the reference's module.
"""
from __future__ import annotations


class AdmissionError(ValueError):
    """Typed backpressure: a request was rejected at (or can never pass)
    admission — over-length prompt, full pending queue, or a (plan, length)
    whose modeled HBM need exceeds the plan's budget."""


class DeadlineExceeded(TimeoutError):
    """A request exceeded its per-request deadline (measured in engine
    steps) while queued or active."""


class CorruptCheckpointError(RuntimeError):
    """A checkpoint file failed validation (truncated / torn write from a
    crashed saver). ``latest_checkpoint`` skips and GCs these; hitting this
    from ``restore_checkpoint`` means an explicit path pointed at debris."""
