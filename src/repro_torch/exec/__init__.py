"""The ExecutionPlan, its scoping and the FastFold facade.

``FastFold`` is imported at first use: the model's modules import
``repro_torch.exec.plan``, which runs this file first, and the facade
imports those modules."""
from repro_torch.exec.plan import (  # noqa: F401
    PRESETS, AsyncPolicy, ExecutionPlan, KernelPolicy, MemoryPolicy,
    ParallelPolicy, current_plan, preset, use_plan)


def __getattr__(name):
    if name == "FastFold":
        from repro_torch.exec.session import FastFold

        return FastFold
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
