"""Runtime observability: contextvar-scoped tracing/metrics, the JSONL
event sink, and the report/aggregation pass. The port's copy of the
reference's package: the same schema, so one report reads the streams of
both.

Scoping follows the repo-wide idiom (``use_plan``, ``inject_faults``):
nothing is global, nothing is ambient. With no tracer scoped, every hook
in this package is a single contextvar read returning a no-op — the
instrumented train loop is bit-identical to its uninstrumented self
(asserted in ``tests/test_torch_obs.py``). With one:

    from repro_torch.obs import use_tracer

    with use_tracer() as tr:
        state, metrics = step(state, batch, gen)
    tr.dump_jsonl("run.jsonl")
    # python -m repro_torch.obs report run.jsonl

Event schema (stable; SCHEMA_VERSION lives in ``events.py``)
-----------------------------------------------------------
One JSON object per line. Common fields on every event:

    seq    emit-order sequence number — the deterministic ordering key.
           Two runs of the same deterministic workload yield the same
           (kind, name, attrs) sequence; only ``*_ns`` durations differ.
    t_ns   monotonic ns since tracer start (never wall clock).
    kind   one of the kinds below.
    name   kind-specific (span name, counter name, request phase, ...).

Kinds and their required fields:

    meta        attrs                    run facts (param_count,
                                         param_bytes, cache_row_bytes,
                                         n_slots, model, ...)
    def         value                    interned payload: ``name`` is a
                                         short label (e.g. "plan:0"),
                                         ``value`` the full serialized
                                         ExecutionPlan — emitted once,
                                         referenced by label thereafter
    span        span_id, parent_id,      nesting tree + interval;
                t_start_ns, dur_ns,      ``timed_call`` leaf spans add
                status, attrs            attrs.dispatch_ns (host return:
                                         the launches, and a first
                                         call's kernel builds) and
                                         attrs.block_ns (the device
                                         synchronise = execute)
    counter     delta, value, attrs      cumulative monotonic counter
    gauge       value, attrs             point-in-time (queue_depth,
                                         occupancy, ...)
    request     uid, attrs               serving lifecycle: name is the
                                         phase — queued, rejected,
                                         admitted, prefill, done,
                                         failed, retried, degraded,
                                         quarantined. Exactly one
                                         terminal (done|failed) per
                                         queued uid; ``reconcile``
                                         enforces it
    train_step  step, dur_ns, tokens,    one step: its host time, which
                metrics                  ends after the step's one wait
                                         for the device (the guard's
                                         ``ok.cpu()``, span
                                         ``train.wait``), optional
                                         tokens/step, metrics resolved
                                         at serialization time
    jit_entry   key, cache               one call through a plan-keyed
                                         jit site; extra distinct keys
                                         per site bump the
                                         ``trace_cache_miss`` counter
                                         (plan-hash-churn detector)

Adding a span to a new subsystem
--------------------------------
1. ``from repro_torch.obs import trace as obs`` in the subsystem module (the
   alias keeps call sites short and greppable).
2. Wrap host-side phases with ``with obs.span("mysys.phase", key=val):``
   — free when unscoped, nested automatically when inside another span.
   Attributes are ints, floats and strings, cheap to build (they are
   built even when no tracer is scoped), never tensors. What the body
   learns goes in with ``obs.annotate(key=val)``.
   While a tracer is scoped and ``torch.profiler`` records, the span also
   opens a ``record_function`` range of its name: the profiler's trace then
   holds it on the device trace's clock, around the kernels its body
   launched. With no tracer nothing enters the profiler.
   Spans are host-thread phases: a span opened inside a backward or a
   checkpointed block's recompute runs on autograd's device thread, where
   no tracer is scoped, and is a no-op. Put spans around the call that
   runs the backward (``torch.autograd.grad``), not inside it.
3. Time device calls with ``obs.timed_call("mysys.kernel", fn, *args)``
   to get the dispatch/execute split; note it adds one device
   synchronise, so only use it on paths that already wait for the device
   (or that you are explicitly profiling).
4. If the call runs a plan-keyed compiled path, also call
   ``tr.jit_entry("mysys.kernel", label)`` with an interned label from
   ``tr.define("plan", plan.to_dict())`` so cache churn is counted.
5. Counters/gauges: ``obs.count("mysys.things")``,
   ``obs.gauge("mysys.depth", n)``.
6. New event *kinds* (rare) go through ``events.py``: add the kind to
   ``KINDS``, document it here, bump SCHEMA_VERSION if a required field
   changes. Free-form additions belong in ``attrs`` (always backward
   compatible).

``events.py`` and ``report.py`` are pure Python: the schema validator
and aggregator run without torch.
"""
from repro_torch.obs.events import (KINDS, REQUEST_PHASES, SCHEMA_VERSION,
                              TERMINAL_PHASES, read_jsonl, validate_event,
                              validate_events)
from repro_torch.obs.report import (aggregate, hardware_efficiency, quantiles,
                              reconcile, render_report)
from repro_torch.obs.trace import (Tracer, annotate, count, current_tracer,
                                   emit, gauge, json_safe, monotonic_ns, span,
                                   timed_call, use_tracer)

__all__ = [
    "KINDS", "REQUEST_PHASES", "SCHEMA_VERSION", "TERMINAL_PHASES",
    "Tracer", "aggregate", "annotate", "count", "current_tracer", "emit",
    "gauge", "hardware_efficiency", "json_safe", "monotonic_ns", "quantiles",
    "read_jsonl", "reconcile", "render_report", "span", "timed_call",
    "use_tracer", "validate_event", "validate_events",
]
