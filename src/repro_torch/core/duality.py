"""Duality Async Operation (paper §IV.C, Fig. 7): the port's counterpart of
the reference's ``core/duality.py``.

The reference leaves the overlap to XLA's scheduler and fences each window
with an optimization barrier. PyTorch runs eagerly, so the port takes the
paper's own design, a pair of autograd operations:

* ``trigger(dist, kind, x, **kw)`` launches the collective with
  ``async_op=True`` and returns a handle holding its receive buffer and its
  work handle;
* ``block(handle)`` waits on it and returns the result.

Between the two, the caller computes what does not need the result. The
backwards mirror the forward: ``block``'s backward triggers the dual
collective on the gradient (all-to-all ↔ the reverse all-to-all,
all-gather ↔ reduce-scatter), and ``trigger``'s backward blocks on it, so the
dual is in flight during the backward of the same compute that the forward
collective overlapped. Autograd runs the nodes made between the two first
(it takes the ready node made last), so the window holds the same compute
in both passes. A trigger and its block are made inside one checkpointed
Evoformer block: the recompute makes both again, in the same order on
every rank, and no work handle crosses a checkpoint's boundary. The handle
holds the collective's input and receive buffer until the block, so neither
is freed while the collective may still use them.

With ``plan.duality.overlap_windows=False`` (``exec.plan.AsyncPolicy``) a
trigger runs the synchronous collective and its block returns the result:
the same numbers, bit for bit. Under ``LocalDist`` both are the identity.

The windows the Evoformer opens (``core/evoformer.py``): the pair-bias
gathers across the QKV projection, the outer-product-mean's and the
triangle updates' gathers across their left operands, and the MSA
swap-back all-to-all, triggered right after the outer-product-mean and
blocked at the end of the block, after the whole pair stack.

``overlap_report`` has no HLO to read. With a recorder installed
(``use_recorder``), each trigger and block records an event, and ``mark``
records a compute event where the Evoformer marks its sites, in the forward
and in the backward; the report says, per collective, which compute lay
between its trigger and its block.
"""
from __future__ import annotations

import itertools
from contextlib import contextmanager
from contextvars import ContextVar

import torch

from repro_torch.core.dist import LocalDist, _dual
from repro_torch.exec.plan import current_plan

_RECORDER: ContextVar[list | None] = ContextVar("repro_torch_duality_log",
                                                default=None)
_IDS = itertools.count()


class _Ready:
    """A window that is no window: the result is in hand."""

    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value


class Handle:
    """A launched asynchronous collective and the state its backward needs:
    the backend, the collective, the pending forward and the pending dual."""

    __slots__ = ("dist", "kind", "kw", "fwd", "bwd", "log", "id")

    def __init__(self, dist, kind, kw, log):
        self.dist, self.kind, self.kw, self.log = dist, kind, kw, log
        self.fwd = self.bwd = None
        self.id = next(_IDS)

    def record(self, what: str, phase: str):
        if self.log is not None:
            self.log.append((what, self.id, self.kind, phase))


class _Trigger(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, h):
        ctx.h = h
        h.fwd = h.dist.start(h.kind, x, async_op=True, **h.kw)
        h.record("trigger", "forward")
        return h.fwd.recv

    @staticmethod
    def backward(ctx, g_raw):
        h = ctx.h
        pending, h.bwd = h.bwd, None
        grad = pending.wait()
        h.record("block", "backward")
        return grad, None


class _Block(torch.autograd.Function):
    @staticmethod
    def forward(ctx, raw, h):
        ctx.h = h
        pending, h.fwd = h.fwd, None
        out = pending.wait()
        h.record("block", "forward")
        return out

    @staticmethod
    def backward(ctx, g):
        h = ctx.h
        kind, kw = _dual(h.kind, h.kw)
        h.bwd = h.dist.start(kind, g, async_op=True, phase="backward", **kw)
        h.record("trigger", "backward")
        # The dual's receive buffer has the forward's receive buffer's
        # shape: both hold the N chunks one rank exchanges.
        return h.bwd.recv, None


def trigger(dist, kind: str, x: torch.Tensor, **kw):
    """Launch collective ``kind`` ("all_to_all" with ``split_axis`` and
    ``concat_axis``, or "all_gather" with ``axis``) on ``x``; ``block`` the
    returned handle for its result. Under ``LocalDist`` the identity; with
    the plan's overlap windows off, the synchronous collective."""
    if isinstance(dist, LocalDist):
        return _Ready(x)
    if not current_plan().duality.overlap_windows:
        return _Ready(getattr(dist, kind)(x, **kw))
    h = Handle(dist, kind, kw, _RECORDER.get())
    return (_Trigger.apply(x, h), h)


def block(pending) -> torch.Tensor:
    """The result of ``trigger``'s collective, waiting for it if needed."""
    if isinstance(pending, _Ready):
        return pending.value
    raw, h = pending
    return _Block.apply(raw, h)


class _Mark(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, label, log):
        ctx.label, ctx.log = label, log
        log.append(("compute", label, None, "forward"))
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.log.append(("compute", ctx.label, None, "backward"))
        return g, None, None


def mark(x: torch.Tensor, label: str) -> torch.Tensor:
    """Record that the compute ``label`` starts here, in the forward and
    (where a graph is built) in the backward; ``x`` itself when no recorder
    is installed."""
    log = _RECORDER.get()
    if log is None:
        return x
    return _Mark.apply(x, label, log)


@contextmanager
def use_recorder():
    """Record the triggers, blocks and compute marks made in this scope
    (and in the backwards of the graphs built in it) into the yielded
    list of ``(event, id or label, collective, pass)``."""
    log: list = []
    token = _RECORDER.set(log)
    try:
        yield log
    finally:
        _RECORDER.reset(token)


def overlap_report(events) -> dict:
    """Per trigger-block pair of an event log: the collective, the pass,
    and the compute labels recorded between them; plus the counts the
    reference's report gives (pairs, pairs with compute between)."""
    open_: dict[tuple, int] = {}
    windows = []
    for pos, (what, key, kind, phase) in enumerate(events):
        if what == "trigger":
            open_[(key, phase)] = pos
        elif what == "block" and (key, phase) in open_:
            start = open_.pop((key, phase))
            compute = [(e[1], e[3]) for e in events[start + 1:pos]
                       if e[0] == "compute"]
            windows.append({"id": key, "collective": kind, "pass": phase,
                            "compute": compute})
    return {"pairs": len(windows),
            "pairs_with_compute_between": sum(bool(w["compute"])
                                              for w in windows),
            "windows": windows}
