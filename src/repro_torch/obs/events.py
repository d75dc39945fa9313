"""The stable event schema of the obs JSONL sink, plus its validator.

One JSON object per line. Every event carries the common fields

    seq     int   emit-order sequence number (the deterministic ordering
                  key — strictly increasing within a stream)
    t_ns    int   monotonic ns since tracer start (never wall clock)
    kind    str   one of KINDS below
    name    str   kind-specific name (span name, counter name, request
                  phase, interned-def label, jit site)

and the kind-specific fields listed in KINDS. ``attrs`` is always a JSON
object of free-form, kind-documented attributes — adding an attr is a
backward-compatible schema change; adding/removing a required field or a
kind bumps SCHEMA_VERSION.

Kinds:

    meta        run metadata (model/engine facts the report needs:
                param_count, param_bytes, cache_row_bytes, n_slots, ...).
    def         an interned value definition: ``name`` is the label
                (e.g. "plan:0"), ``value`` the full payload (e.g. the
                serialized ExecutionPlan). Later events reference the
                label — the full plan appears exactly once per stream.
    span        a closed span: span_id/parent_id give the nesting tree,
                t_start_ns/dur_ns the interval, status "ok"|"error".
                ``timed_call`` leaf spans carry attrs.dispatch_ns/block_ns
                (host dispatch, a first call's builds included / device
                execute).
    counter     monotonic counter increment: delta and the cumulative
                value.
    gauge       point-in-time measurement (queue_depth, occupancy, ...).
    request     serving-engine lifecycle event: ``name`` is the phase
                (REQUEST_PHASES), ``uid`` the request id (null for
                rejected-at-submit, which never got one).
    train_step  one train-loop step: step index, its host dur_ns (to
                the end of the step's one wait for the device), optional
                tokens-per-step for throughput, and metrics {loss,
                grad_norm, nonfinite_skips} resolved at serialization
                time.
    jit_entry   one call through a plan-keyed jit site: key (the interned
                plan label), cache "miss"|"hit".

Request lifecycle (the typed per-request stream):

    queued -> admitted -> (prefill span) -> per-plan-group decode spans
           -> done | failed
    with retried / degraded / quarantined / rejected interleaved as the
    failure machinery routes the request. Exactly one terminal phase
    (done|failed) per queued uid — ``repro_torch.obs.report.reconcile`` checks
    this, and the chaos-reconciliation test proves it under injected
    faults.

This module is pure Python (no torch): the tests feed it raw dicts and
files. It is the port's copy of the reference's schema.
"""
from __future__ import annotations

import json

SCHEMA_VERSION = 1

_NUM = (int, float)

#: kind -> {field: allowed types} beyond the common fields. A ``None`` in
#: the tuple marks the field as nullable.
KINDS: dict[str, dict[str, tuple]] = {
    "meta": {"attrs": (dict,)},
    "def": {"value": (dict, str, list)},
    "span": {"span_id": (int,), "parent_id": (int, None),
             "t_start_ns": _NUM, "dur_ns": _NUM, "status": (str,),
             "attrs": (dict,)},
    "counter": {"delta": _NUM, "value": _NUM, "attrs": (dict,)},
    "gauge": {"value": _NUM, "attrs": (dict,)},
    "request": {"uid": (int, None), "attrs": (dict,)},
    "train_step": {"step": (int,), "dur_ns": _NUM, "metrics": (dict,),
                   "tokens": (int, float, None)},
    "jit_entry": {"key": (str,), "cache": (str,)},
}

REQUEST_PHASES = ("queued", "rejected", "admitted", "prefill", "done",
                  "failed", "retried", "degraded", "quarantined")
TERMINAL_PHASES = ("done", "failed")
SPAN_STATUSES = ("ok", "error")
JIT_CACHE = ("miss", "hit")


def _typecheck(value, types) -> bool:
    for t in types:
        if t is None:
            if value is None:
                return True
        elif isinstance(value, t) and not (t in (int, float)
                                           and isinstance(value, bool)):
            return True
    return False


def validate_event(ev) -> list[str]:
    """Schema problems of one event dict (empty = valid)."""
    problems: list[str] = []
    if not isinstance(ev, dict):
        return [f"event is not an object: {ev!r}"]
    where = f"event seq={ev.get('seq')!r}"
    for field, types in (("seq", (int,)), ("t_ns", _NUM), ("kind", (str,)),
                         ("name", (str,))):
        if field not in ev:
            problems.append(f"{where}: missing common field {field!r}")
        elif not _typecheck(ev[field], types):
            problems.append(f"{where}: {field}={ev[field]!r} has wrong type")
    kind = ev.get("kind")
    if kind not in KINDS:
        problems.append(f"{where}: unknown kind {kind!r}")
        return problems
    for field, types in KINDS[kind].items():
        if field not in ev:
            problems.append(f"{where} ({kind}): missing field {field!r}")
        elif not _typecheck(ev[field], types):
            problems.append(
                f"{where} ({kind}): {field}={ev[field]!r} has wrong type")
    extra = set(ev) - {"seq", "t_ns", "kind", "name"} - set(KINDS[kind])
    if extra:
        problems.append(f"{where} ({kind}): undeclared fields {sorted(extra)}"
                        " — extend the schema, don't freelance")
    if kind == "request" and ev.get("name") not in REQUEST_PHASES:
        problems.append(f"{where}: unknown request phase {ev.get('name')!r}")
    if kind == "span" and ev.get("status") not in SPAN_STATUSES:
        problems.append(f"{where}: unknown span status {ev.get('status')!r}")
    if kind == "jit_entry" and ev.get("cache") not in JIT_CACHE:
        problems.append(f"{where}: jit_entry cache={ev.get('cache')!r}")
    return problems


def validate_events(events) -> list[str]:
    """Schema problems of a whole stream, including seq monotonicity."""
    problems: list[str] = []
    last_seq = -1
    for ev in events:
        problems.extend(validate_event(ev))
        seq = ev.get("seq") if isinstance(ev, dict) else None
        if isinstance(seq, int):
            if seq <= last_seq:
                problems.append(
                    f"event seq={seq}: not strictly increasing "
                    f"(previous {last_seq})")
            last_seq = seq
    return problems


def read_jsonl(path) -> list[dict]:
    """Load an event stream written by ``Tracer.dump_jsonl``."""
    events: list[dict] = []
    with open(path, encoding="utf-8") as fh:
        for i, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError as err:
                raise ValueError(f"{path}:{i}: not JSON: {err}") from err
    return events
