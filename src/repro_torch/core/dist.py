"""Distribution backends of the Evoformer: the port's copy of the
reference's ``core/dist.py`` as far as the port runs, which is one device.

``LocalDist`` is the identity backend: one DAP device, so the forward plans
its chunks with ``axis_size = 1`` and every collective of the reference is
the identity (the single-device Evoformer of ``core/evoformer.py`` makes
none). The DAP backends are ROADMAP.md Queue 1 item 3.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class LocalDist:
    """Identity backend (one DAP device)."""

    axis_size: int = 1


def dist_from_policy(policy) -> LocalDist:
    """The backend an ``exec.plan.ParallelPolicy`` names: ``"local"`` only;
    the others raise, naming the ROADMAP item that ports them."""
    if policy.backend == "local":
        return LocalDist()
    raise NotImplementedError(
        f"ParallelPolicy.backend={policy.backend!r}: the port runs on one "
        "device ('local'); DAP is ROADMAP.md Queue 1 item 3")
