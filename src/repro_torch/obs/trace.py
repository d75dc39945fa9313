"""Structured tracing and metrics, contextvar-scoped like ``use_plan`` and
``inject_faults``: zero overhead and zero behavior change when no tracer is
scoped (every module-level hook is one contextvar read returning a no-op),
one in-memory event stream when one is.

    from repro_torch.obs import use_tracer

    with use_tracer() as tr:
        state, metrics = step(state, batch, gen)   # one train_step event
    tr.dump_jsonl("run.jsonl")
    # python -m repro_torch.obs report run.jsonl

Clocks: every timestamp is ``time.perf_counter_ns`` relative to the
tracer's start (monotonic — never wall clock, so events order correctly
across NTP steps and the stream is diffable across runs up to durations).
Events additionally carry a ``seq`` number assigned at emit time, which IS
the deterministic ordering key: two runs of the same deterministic workload
produce the same event sequence (kinds/names/attrs), differing only in the
``*_ns`` fields. That clock is not the device trace's: while
``torch.profiler`` records, each span also opens a ``record_function``
range of its name, which the profiler stamps on its own clock beside the
kernels the span's body launches.

The device-aware timer (``timed_call``) separates host dispatch from device
execution by synchronising the CUDA device of the call's tensor outputs:
``dispatch_ns`` is the host time for the call to return (the launches
queued; on a first call it also holds any kernel build), ``block_ns`` is the
wait for the device to finish (the execute time). Where every output lies on
the CPU there is nothing to wait for and ``block_ns`` is the time of an
empty walk over the outputs.

Trace-cache-miss detection: instrumented plan-keyed sites call
``jit_entry(site, key)`` with a stable key (the serialized ExecutionPlan).
The first distinct key per site is the expected trace; every ADDITIONAL
distinct key increments the ``trace_cache_miss`` counter — plan-hash churn
(distinct plans silently multiplying jit entries, the regression the
ExecutionPlan hashability contract worries about) shows up as a counter
instead of an invisible compile stall.

Values stored in events may be 0-d tensors on the card (the train-step
metrics path records them *without* forcing a host sync); they are resolved
to floats only when the tracer serializes (``events_resolved``/
``dump_jsonl``) — off the hot path by construction.

The port's copy of the reference's module. It imports no torch (the
``timed_call`` import is local) and is single-thread-per-tracer by design:
the instrumented loops (the train step loop; the serving engine, when the
port has one) are host-side sequential loops.
"""
from __future__ import annotations

import json
import sys
import time
from contextlib import contextmanager, nullcontext
from contextvars import ContextVar
from typing import Any, Callable, Optional


def monotonic_ns() -> int:
    """The obs clock: monotonic, ns. Exposed so host-side step loops (e.g.
    ``train/loop.instrument_train_step``) time through the sanctioned obs
    entry point instead of reading ``time.*`` in traced modules.
    """
    return time.perf_counter_ns()


def json_safe(v: Any) -> Any:
    """Resolve a recorded value for serialization. Scalars (including 0-d
    tensors recorded lazily) become floats — THIS is where any deferred
    device transfer happens, never at emit time. A value with more than one
    element (``float`` raises RuntimeError on a tensor) is kept as its
    repr."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, dict):
        return {k: json_safe(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [json_safe(x) for x in v]
    try:
        return float(v)
    except (TypeError, ValueError, RuntimeError):
        return repr(v)


def _cuda_devices(out) -> list:
    """The distinct CUDA devices of the tensors in ``out`` (nested tuples,
    lists and dict values), in first-seen order; none for CPU tensors."""
    seen: list = []
    stack = [out]
    while stack:
        v = stack.pop()
        if isinstance(v, dict):
            stack.extend(reversed(list(v.values())))
        elif isinstance(v, (list, tuple)):
            stack.extend(reversed(v))
        else:
            dev = getattr(v, "device", None)
            if getattr(dev, "type", None) == "cuda" and dev not in seen:
                seen.append(dev)
    return seen


def _synchronize(device) -> None:
    import torch  # local: this module stays importable without torch

    torch.cuda.synchronize(device)


def _profiler_range(name: str):
    """An entered ``torch.profiler.record_function`` range named ``name``
    while the torch profiler records, else None. torch is only looked up,
    never imported: a process without it has no profiler running."""
    torch = sys.modules.get("torch")
    if torch is None or not torch._C._autograd._profiler_enabled():
        return None
    rf = torch.profiler.record_function(name)
    rf.__enter__()
    return rf


class Tracer:
    """In-memory event stream + counters. Build one per scenario (like a
    FaultInjector) and scope it with ``use_tracer``; see the module
    docstring of ``repro/obs/__init__.py`` for the full event schema."""

    def __init__(self, *, clock: Callable[[], int] = monotonic_ns):
        self._clock = clock
        self._t0 = clock()
        self._seq = 0
        self.events: list[dict] = []
        self.counters: dict[str, float] = {}
        self._span_stack: list[int] = []
        self._span_attrs: list[dict] = []       # the open spans' attrs
        self._next_span = 0
        self._defs: dict[str, str] = {}          # interned value -> label
        self._def_counts: dict[str, int] = {}    # kind -> next index
        self._jit_keys: dict[str, dict[str, int]] = {}

    # -- core -------------------------------------------------------------

    def _now(self) -> int:
        return self._clock() - self._t0

    def emit(self, kind: str, name: str, **fields) -> dict:
        ev = {"seq": self._seq, "t_ns": self._now(), "kind": kind,
              "name": name, **fields}
        self._seq += 1
        self.events.append(ev)
        return ev

    # -- spans ------------------------------------------------------------

    @contextmanager
    def span(self, name: str, **attrs):
        """Nestable span on the monotonic clock, and a profiler range of
        the same name while the torch profiler records. Exception-safe: the
        span event is emitted (``status="error"``) and the stack restored
        even when the body raises; the exception propagates."""
        span_id = self._next_span
        self._next_span += 1
        parent = self._span_stack[-1] if self._span_stack else None
        self._span_stack.append(span_id)
        self._span_attrs.append(attrs)
        rf = _profiler_range(name)
        t0 = self._now()
        status = "ok"
        try:
            yield span_id
        # status-only observer: re-raises unconditionally, so the typed
        # fault hierarchy passes through untouched
        # repro-lint: disable=R002
        except BaseException:
            status = "error"
            raise
        finally:
            t1 = self._now()
            if rf is not None:
                rf.__exit__(None, None, None)
            self._span_stack.pop()
            self._span_attrs.pop()
            self.emit("span", name, span_id=span_id, parent_id=parent,
                      t_start_ns=t0, dur_ns=t1 - t0, status=status,
                      attrs=dict(attrs))

    def annotate(self, **attrs) -> None:
        """Add ``attrs`` to the innermost open span (what its body learns,
        such as a plan it chose); nothing when no span is open."""
        if self._span_attrs:
            self._span_attrs[-1].update(attrs)

    def timed_call(self, name: str, fn, *args,
                   attrs: Optional[dict] = None, **kw):
        """Call ``fn`` under a leaf span with the device-aware
        dispatch/execute split (see module docstring). Adds one synchronise
        of each CUDA device the outputs lie on — use on paths that already
        wait for the device each step, not on fire-and-forget hot paths."""

        span_id = self._next_span
        self._next_span += 1
        parent = self._span_stack[-1] if self._span_stack else None
        t0 = self._now()
        out = fn(*args, **kw)
        t1 = self._now()
        for dev in _cuda_devices(out):
            _synchronize(dev)
        t2 = self._now()
        self.emit("span", name, span_id=span_id, parent_id=parent,
                  t_start_ns=t0, dur_ns=t2 - t0, status="ok",
                  attrs={**(attrs or {}),
                         "dispatch_ns": t1 - t0, "block_ns": t2 - t1})
        return out

    # -- metrics ----------------------------------------------------------

    def count(self, name: str, delta: float = 1.0, **attrs) -> float:
        value = self.counters.get(name, 0.0) + delta
        self.counters[name] = value
        self.emit("counter", name, delta=delta, value=value,
                  attrs=dict(attrs))
        return value

    def gauge(self, name: str, value, **attrs):
        self.emit("gauge", name, value=value, attrs=dict(attrs))

    # -- interning + jit-entry tracking -----------------------------------

    def define(self, kind: str, value) -> str:
        """Intern ``value`` (JSON-safe) under a deterministic ``kind:N``
        label, emitting one ``def`` event the first time. Events then carry
        the short label instead of repeating the full value (e.g. the
        serialized ExecutionPlan) on every request."""
        key = kind + "\x00" + (value if isinstance(value, str)
                               else json.dumps(value, sort_keys=True))
        label = self._defs.get(key)
        if label is None:
            idx = self._def_counts.get(kind, 0)
            self._def_counts[kind] = idx + 1
            label = f"{kind}:{idx}"
            self._defs[key] = label
            self.emit("def", label, value=value)
        return label

    def jit_entry(self, site: str, key: str) -> bool:
        """Record one call through a plan-keyed jit site. Returns True on a
        trace-cache miss (first sighting of ``key`` at ``site``); misses
        beyond the first per site bump the ``trace_cache_miss`` counter —
        the plan-hash-churn detector."""
        seen = self._jit_keys.setdefault(site, {})
        miss = key not in seen
        if miss:
            seen[key] = len(seen)
        self.emit("jit_entry", site, key=key,
                  cache="miss" if miss else "hit")
        if miss and len(seen) > 1:
            self.count("trace_cache_miss", site=site)
        return miss

    # -- serialization ----------------------------------------------------

    def events_resolved(self) -> list[dict]:
        """Events with every lazily-recorded value resolved to JSON-safe
        types (forces any deferred device transfers — call off the hot
        path)."""
        return [json_safe(e) for e in self.events]

    def dump_jsonl(self, path_or_file) -> int:
        """Write the resolved event stream as JSONL (one event per line,
        the documented stable schema). Returns the event count."""
        events = self.events_resolved()
        if hasattr(path_or_file, "write"):
            for e in events:
                path_or_file.write(json.dumps(e, sort_keys=True) + "\n")
        else:
            with open(path_or_file, "w", encoding="utf-8") as fh:
                for e in events:
                    fh.write(json.dumps(e, sort_keys=True) + "\n")
        return len(events)


# ---------------------------------------------------------------------------
# Scoping (mirrors exec.plan.use_plan / resilience.inject_faults)
# ---------------------------------------------------------------------------

_TRACER: ContextVar[Optional[Tracer]] = ContextVar("repro_tracer",
                                                   default=None)


def current_tracer() -> Optional[Tracer]:
    """The innermost ``use_tracer`` scope's tracer, else None."""
    return _TRACER.get()


@contextmanager
def use_tracer(tracer: Optional[Tracer] = None):
    """Scope a Tracer (re-entrant, exception-safe restore). Pass a pre-built
    Tracer to accumulate several scopes into one stream, or nothing to get
    a fresh one."""
    tr = tracer if tracer is not None else Tracer()
    if not isinstance(tr, Tracer):
        raise TypeError(f"use_tracer expects a Tracer, got {tr!r}")
    token = _TRACER.set(tr)
    try:
        yield tr
    finally:
        _TRACER.reset(token)


# ---------------------------------------------------------------------------
# Module-level no-op hooks (the instrumentation surface: one contextvar
# read when unscoped, like resilience.fire)
# ---------------------------------------------------------------------------

_NULL_SPAN = nullcontext(None)


def span(name: str, **attrs):
    """A tracer span, or a reusable null context when unscoped."""
    tr = _TRACER.get()
    if tr is None:
        return _NULL_SPAN
    return tr.span(name, **attrs)


def annotate(**attrs) -> None:
    """Add ``attrs`` to the scoped tracer's innermost open span."""
    tr = _TRACER.get()
    if tr is not None:
        tr.annotate(**attrs)


def emit(kind: str, name: str, **fields) -> None:
    tr = _TRACER.get()
    if tr is not None:
        tr.emit(kind, name, **fields)


def count(name: str, delta: float = 1.0, **attrs) -> None:
    tr = _TRACER.get()
    if tr is not None:
        tr.count(name, delta, **attrs)


def gauge(name: str, value, **attrs) -> None:
    tr = _TRACER.get()
    if tr is not None:
        tr.gauge(name, value, **attrs)


def timed_call(name: str, fn, *args, attrs: Optional[dict] = None, **kw):
    """``fn(*args, **kw)`` — direct call when unscoped, dispatch/execute
    timed span when a tracer is active."""
    tr = _TRACER.get()
    if tr is None:
        return fn(*args, **kw)
    return tr.timed_call(name, fn, *args, attrs=attrs, **kw)
