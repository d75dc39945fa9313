"""The environment variables of the port, read in one place: the port's
copy of the reference's ``exec/envcompat.py``.

  REPRO_PLAN=<preset>              start from a named preset
                                   (default | oracle | interpret |
                                    triangle-oracle)
  REPRO_DISABLE_KERNELS=1          -> KernelPolicy.enabled = False
  REPRO_PALLAS_INTERPRET=1         -> KernelPolicy.interpret = True
  REPRO_FORCE_TRIANGLE_ORACLE=1    -> KernelPolicy.triangle = opm = "oracle"
  REPRO_FORCE_SCAN_ATTN_BWD=1      -> KernelPolicy.attn_bwd = "scan"

  REPRO_FAULT_SEED=<int>           the default seed of a FaultInjector
                                   (``resilience/faults.py``)

  CUDA_HOME, CUDA_PATH             where the kernels' build looks for nvcc
                                   first (``kernels/_build.py``)

The flags layer on top of the preset. The plan is built when asked for,
never at import, so a variable set after import takes effect.

Left out: the reference's ``force_host_device_count`` (an XLA flag for
simulated host devices; the port's multi-process runs name their world size
to ``torch.distributed``).
"""
from __future__ import annotations

import dataclasses
import os

_ENV_VARS = (
    "REPRO_PLAN",
    "REPRO_DISABLE_KERNELS",
    "REPRO_PALLAS_INTERPRET",
    "REPRO_FORCE_TRIANGLE_ORACLE",
    "REPRO_FORCE_SCAN_ATTN_BWD",
)

# Keyed on the variables' values: the environment is read on every call,
# the plan rebuilt only when one of them changed.
_cache: dict[tuple, object] = {}


def _flag(name: str) -> bool:
    return os.environ.get(name, "0") == "1"


def plan_from_env():
    """ExecutionPlan for the current process environment."""
    from repro_torch.exec import plan as planmod

    key = tuple(os.environ.get(v) for v in _ENV_VARS)
    hit = _cache.get(key)
    if hit is not None:
        return hit

    p = planmod.preset(os.environ.get("REPRO_PLAN", "default"))
    kern = p.kernels
    if _flag("REPRO_DISABLE_KERNELS"):
        kern = dataclasses.replace(kern, enabled=False)
    if _flag("REPRO_PALLAS_INTERPRET"):
        kern = dataclasses.replace(kern, interpret=True)
    if _flag("REPRO_FORCE_TRIANGLE_ORACLE"):
        kern = dataclasses.replace(kern, triangle="oracle", opm="oracle")
    if _flag("REPRO_FORCE_SCAN_ATTN_BWD"):
        kern = dataclasses.replace(kern, attn_bwd="scan")
    if kern is not p.kernels:
        p = p.replace(kernels=kern)
    _cache[key] = p
    return p


def fault_seed() -> int | None:
    """Default FaultInjector seed from REPRO_FAULT_SEED (None when unset),
    so a run can pin a process-wide fault schedule while environment access
    stays confined to this module."""
    v = os.environ.get("REPRO_FAULT_SEED")
    return int(v) if v else None


def cuda_home() -> str | None:
    """The CUDA toolkit's root from CUDA_HOME, else CUDA_PATH (None when
    neither is set): where ``kernels/_build.find_nvcc`` looks first."""
    return os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
