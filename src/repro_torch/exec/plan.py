"""ExecutionPlan: one frozen, hashable policy object for the execution
stack, the port's own copy of the reference's ``exec/plan.py``.

    from repro_torch.exec.plan import ExecutionPlan, KernelPolicy, use_plan

    plan = ExecutionPlan(kernels=KernelPolicy(attention="oracle"))
    with use_plan(plan):
        out = ff.forward(params, batch)   # every attention site materialized

The four policies, their fields, legs, validation, presets and JSON form are
the reference's, so a plan serialises to the same string in both packages.
How the ``KernelPolicy`` legs resolve on the card and on the CPU is the leg
table in ``kernels/ops.py``. ``ParallelPolicy``, ``MemoryPolicy`` and
``AsyncPolicy`` are the reference's too: ``MemoryPolicy.apply`` writes its
budget-free knobs into the EvoformerConfig and ``core.alphafold`` plans the
rest against its ``hbm_budget`` (AutoChunk, ``memory/autochunk.py``);
``ParallelPolicy.make_dist`` builds the backend it names (``core/dist.py``):
``LocalDist`` for ``"local"``, DAP on the process group its ``mesh`` field
holds for ``"shard_map"`` (the stack on shards, ``core.dap``) and
``"gspmd"`` (the whole model); ``AsyncPolicy.overlap_windows`` opens or
closes the Duality-Async windows (``core/duality.py``).

Scoping: ``current_plan()`` is the innermost ``use_plan`` scope's plan,
else the plan the environment asks for (``envcompat.plan_from_env``). The
scope is a ``ContextVar``, which autograd's backward does not see when it
runs on another thread: the ops keep the leg they resolved in their autograd
context, and a checkpointed block re-enters the plan it ran under.
"""
from __future__ import annotations

import dataclasses
import json
from contextlib import contextmanager
from contextvars import ContextVar
from dataclasses import dataclass, field
from typing import Any

_LEGS = ("auto", "pallas", "interpret", "xla", "oracle")
_ATTN_BWD_LEGS = ("auto", "scan")
_DIST_BACKENDS = ("local", "shard_map", "gspmd")
OPS = ("attention", "triangle", "opm", "softmax", "layer_norm", "elementwise")


@dataclass(frozen=True)
class KernelPolicy:
    """Per-op kernel leg selection. ``enabled``/``interpret`` steer every
    ``auto`` op; a per-op field pins that op family regardless of them."""

    enabled: bool = True          # False: "auto" ops -> plain versions
    interpret: bool = False       # the reference's off-TPU validation leg
    attention: str = "auto"
    triangle: str = "auto"
    opm: str = "auto"
    softmax: str = "auto"
    layer_norm: str = "auto"
    elementwise: str = "auto"     # bias_sigmoid_mul / bias_dropout_add
    attn_bwd: str = "auto"        # "scan": the plain attention backward

    def __post_init__(self):
        for op in OPS:
            leg = getattr(self, op)
            if leg not in _LEGS:
                raise ValueError(f"KernelPolicy.{op}={leg!r}: not in {_LEGS}")
        if self.attn_bwd not in _ATTN_BWD_LEGS:
            raise ValueError(
                f"KernelPolicy.attn_bwd={self.attn_bwd!r}: "
                f"not in {_ATTN_BWD_LEGS}")


@dataclass(frozen=True)
class ParallelPolicy:
    """Distribution backend and mesh axis. ``mesh`` holds the
    ``torch.distributed`` process group of the DAP backends (None: the
    default group)."""

    backend: str = "local"
    axis: str = "model"
    mesh: Any = None

    def __post_init__(self):
        if self.backend not in _DIST_BACKENDS:
            raise ValueError(f"ParallelPolicy.backend={self.backend!r}: "
                             f"not in {_DIST_BACKENDS}")

    def make_dist(self):
        """The backend this policy names (``core.dist.dist_from_policy``):
        ``LocalDist``, ``ProcessGroupDist`` or ``WholeModelDist``."""
        from repro_torch.core.dist import dist_from_policy

        return dist_from_policy(self)


@dataclass(frozen=True)
class MemoryPolicy:
    """Device-memory budget and chunk knob overrides. ``hbm_budget=None``
    means the device's own (``device.hbm_budget_bytes``). A nonzero knob
    overrides the EvoformerConfig's value (and is then pinned by the
    AutoChunk planner); ``auto_chunk`` overrides the config's planner
    opt-in when not None."""

    hbm_budget: int | None = None
    auto_chunk: bool | None = None
    inference_chunk: int = 0
    opm_chunk: int = 0
    attn_kv_tile: int = 0
    tri_k_tile: int = 0
    opm_s_tile: int = 0

    _KNOBS = ("inference_chunk", "opm_chunk", "attn_kv_tile", "tri_k_tile",
              "opm_s_tile")

    def apply(self, evo_cfg):
        """EvoformerConfig with this policy's overrides applied (the input
        itself when nothing overrides)."""
        updates = {k: getattr(self, k) for k in self._KNOBS
                   if getattr(self, k)}
        if self.auto_chunk is not None:
            updates["auto_chunk"] = self.auto_chunk
        if not updates:
            return evo_cfg
        return dataclasses.replace(evo_cfg, **updates)


@dataclass(frozen=True)
class AsyncPolicy:
    """Duality-Async overlap windows: False runs each windowed collective
    synchronously (the same numbers); on one device there is no window."""

    overlap_windows: bool = True


# Rung 1 of the degradation ladder: the minimal-transient chunk/tile knobs.
_DEGRADED_MEMORY = dict(inference_chunk=1, opm_chunk=8, attn_kv_tile=32,
                        tri_k_tile=16, opm_s_tile=16)


@dataclass(frozen=True)
class ExecutionPlan:
    """The composed execution policy. Frozen and hashable: equal plans hash
    equal."""

    kernels: KernelPolicy = field(default_factory=KernelPolicy)
    parallel: ParallelPolicy = field(default_factory=ParallelPolicy)
    memory: MemoryPolicy = field(default_factory=MemoryPolicy)
    duality: AsyncPolicy = field(default_factory=AsyncPolicy)

    def replace(self, **kw) -> "ExecutionPlan":
        return dataclasses.replace(self, **kw)

    def with_kernels(self, **kw) -> "ExecutionPlan":
        return self.replace(kernels=dataclasses.replace(self.kernels, **kw))

    def with_parallel(self, **kw) -> "ExecutionPlan":
        return self.replace(parallel=dataclasses.replace(self.parallel, **kw))

    def with_memory(self, **kw) -> "ExecutionPlan":
        return self.replace(memory=dataclasses.replace(self.memory, **kw))

    def with_async(self, **kw) -> "ExecutionPlan":
        return self.replace(duality=dataclasses.replace(self.duality, **kw))

    def degrade(self) -> "ExecutionPlan | None":
        """Next rung of the degradation ladder: (1) every MemoryPolicy
        chunk/tile knob at its minimal-transient setting, then (2) every
        ``auto`` op on its plain version. None when fully degraded."""
        tight = dataclasses.replace(self.memory, **_DEGRADED_MEMORY)
        if self.memory != tight:
            return self.replace(memory=tight)
        if self.kernels.enabled:
            return self.with_kernels(enabled=False)
        return None

    @classmethod
    def from_env(cls) -> "ExecutionPlan":
        """The plan the process environment asks for (``envcompat``),
        read when called, never at import."""
        from repro_torch.exec import envcompat

        return envcompat.plan_from_env()

    def to_dict(self) -> dict:
        """Plain-JSON form of the plan. A plan carrying a live process group
        does not serialise."""
        if self.parallel.mesh is not None:
            raise ValueError(
                "ExecutionPlan.to_dict: ParallelPolicy.mesh holds a live "
                "device mesh; serialize the mesh-free plan and rebind the "
                "mesh on load")
        return {
            "kernels": dataclasses.asdict(self.kernels),
            "parallel": {"backend": self.parallel.backend,
                         "axis": self.parallel.axis},
            "memory": dataclasses.asdict(self.memory),
            "duality": dataclasses.asdict(self.duality),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ExecutionPlan":
        """Inverse of ``to_dict``; the policies' validation applies."""
        return cls(
            kernels=KernelPolicy(**d.get("kernels", {})),
            parallel=ParallelPolicy(**d.get("parallel", {})),
            memory=MemoryPolicy(**d.get("memory", {})),
            duality=AsyncPolicy(**d.get("duality", {})),
        )

    def to_json(self) -> str:
        """Canonical JSON (sorted keys): equal plans give equal strings."""
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "ExecutionPlan":
        return cls.from_dict(json.loads(s))

    def describe(self) -> str:
        k = self.kernels
        per_op = ",".join(f"{op}={getattr(k, op)}" for op in OPS
                          if getattr(k, op) != "auto")
        return (f"kernels(enabled={k.enabled} interpret={k.interpret}"
                f"{' ' + per_op if per_op else ''} attn_bwd={k.attn_bwd}) "
                f"parallel({self.parallel.backend}) "
                f"memory(budget={self.memory.hbm_budget}) "
                f"async(overlap={self.duality.overlap_windows})")


PRESETS: dict[str, ExecutionPlan] = {
    # Kernels enabled: the kernels on the card, plain versions on the CPU.
    "default": ExecutionPlan(),
    # Every op on its plain version (the scores-materialized paths).
    "oracle": ExecutionPlan(kernels=KernelPolicy(enabled=False)),
    # The reference's interpret-mode validation leg: on the card the auto
    # legs still run the kernels, as the reference's do on its TPU.
    "interpret": ExecutionPlan(kernels=KernelPolicy(interpret=True)),
    # Only the pair-stack triangle and OPM ops on their materialized paths.
    "triangle-oracle": ExecutionPlan(
        kernels=KernelPolicy(triangle="oracle", opm="oracle")),
}


def preset(name: str) -> ExecutionPlan:
    try:
        return PRESETS[name]
    except KeyError:
        raise KeyError(
            f"unknown plan preset {name!r}; choose from {sorted(PRESETS)}"
        ) from None


_PLAN: ContextVar[ExecutionPlan | None] = ContextVar(
    "repro_torch_execution_plan", default=None)


def current_plan() -> ExecutionPlan:
    """The innermost ``use_plan`` scope's plan, else the environment's."""
    plan = _PLAN.get()
    if plan is not None:
        return plan
    return ExecutionPlan.from_env()


@contextmanager
def use_plan(plan: ExecutionPlan):
    """Scope ``plan`` as the current execution plan (re-entrant; a nested
    scope restores the outer plan on exit)."""
    if not isinstance(plan, ExecutionPlan):
        raise TypeError(f"use_plan expects an ExecutionPlan, got {plan!r}")
    token = _PLAN.set(plan)
    try:
        yield plan
    finally:
        _PLAN.reset(token)
