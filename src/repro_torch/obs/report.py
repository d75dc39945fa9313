"""Aggregation over an obs event stream + the report renderer.

Pure-python passes over the stable event schema (``repro/obs/events.py``):

  aggregate(events)   span percentiles (p50/p95/p99) + per-span self-time,
                      counter totals, gauge stats + occupancy histograms,
                      request lifecycle tallies + queued->done latency
                      percentiles, train-step stats, jit-entry/cache-miss
                      census, merged run metadata.
  reconcile(events)   lifecycle invariant check: every queued request ends
                      in exactly one terminal phase (done|failed), no
                      terminal without a queued, no post-terminal events.
  hardware_efficiency(agg)
                      cross-references measured per-token prefill/decode
                      time against the published peaks of the card the
                      port targets (``repro_torch.device``: one NVIDIA
                      H100 SXM, bf16 FLOP/s and HBM bandwidth) using the
                      model facts the engine put in its ``meta`` event —
                      prints the fraction of roofline each phase achieves.
                      The modeled floor is per card; on a CPU the fraction
                      is honest and tiny.
  render_report(events)
                      the ``python -m repro_torch.obs report`` body.

Only ``hardware_efficiency`` reads a port module (the card's constants,
imported lazily); everything else is pure Python.
"""
from __future__ import annotations

from repro_torch.obs.events import TERMINAL_PHASES, validate_events  # noqa: F401

_QS = (0.5, 0.95, 0.99)


def quantiles(xs, qs=_QS) -> dict[str, float]:
    """Nearest-rank percentiles, keyed 'p50'/'p95'/'p99'."""
    if not xs:
        return {f"p{int(q * 100)}": 0.0 for q in qs}
    s = sorted(xs)
    out = {}
    for q in qs:
        idx = min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))
        out[f"p{int(q * 100)}"] = float(s[idx])
    return out


def aggregate(events: list[dict]) -> dict:
    spans: dict[str, dict] = {}
    child_ns: dict[int, float] = {}       # parent span_id -> sum(child dur)
    span_rows: list[dict] = []
    counters: dict[str, float] = {}
    gauges: dict[str, list[float]] = {}
    requests: dict[str, int] = {}
    req_t: dict[int, dict[str, float]] = {}   # uid -> phase -> first t_ns
    prompt_tokens = 0
    train_durs: list[float] = []
    train_skips = 0.0
    train_tokens = 0.0
    last_metrics: dict = {}
    jit: dict[str, dict] = {}
    meta: dict = {}
    defs: dict[str, object] = {}

    for ev in events:
        kind = ev.get("kind")
        if kind == "span":
            span_rows.append(ev)
            if ev.get("parent_id") is not None:
                child_ns[ev["parent_id"]] = (
                    child_ns.get(ev["parent_id"], 0.0) + ev["dur_ns"])
        elif kind == "counter":
            counters[ev["name"]] = ev["value"]
        elif kind == "gauge":
            gauges.setdefault(ev["name"], []).append(float(ev["value"]))
        elif kind == "request":
            phase = ev["name"]
            requests[phase] = requests.get(phase, 0) + 1
            uid = ev.get("uid")
            if uid is not None:
                req_t.setdefault(uid, {}).setdefault(phase, ev["t_ns"])
            if phase == "admitted":
                prompt_tokens += int(ev.get("attrs", {}).get(
                    "prompt_len", 0))
        elif kind == "train_step":
            train_durs.append(float(ev["dur_ns"]))
            m = ev.get("metrics", {})
            last_metrics = m
            train_skips += float(m.get("nonfinite_skips", 0.0) or 0.0)
            train_tokens += float(ev.get("tokens") or 0.0)
        elif kind == "jit_entry":
            site = jit.setdefault(ev["name"], {"calls": 0, "misses": 0,
                                               "keys": set()})
            site["calls"] += 1
            site["keys"].add(ev["key"])
            if ev["cache"] == "miss":
                site["misses"] += 1
        elif kind == "meta":
            meta.update(ev.get("attrs", {}))
        elif kind == "def":
            defs[ev["name"]] = ev.get("value")

    for ev in span_rows:
        name = ev["name"]
        s = spans.setdefault(name, {"count": 0, "total_ns": 0.0,
                                    "self_ns": 0.0, "exec_ns": 0.0,
                                    "dispatch_ns": 0.0, "errors": 0,
                                    "durs": []})
        s["count"] += 1
        s["total_ns"] += ev["dur_ns"]
        s["self_ns"] += ev["dur_ns"] - child_ns.get(ev["span_id"], 0.0)
        s["durs"].append(float(ev["dur_ns"]))
        attrs = ev.get("attrs") or {}
        # timed_call leaf spans: device-execute vs host-dispatch (a first
        # call's dispatch carries its kernel builds)
        s["exec_ns"] += float(attrs.get("block_ns", 0.0))
        s["dispatch_ns"] += float(attrs.get("dispatch_ns", 0.0))
        if ev.get("status") == "error":
            s["errors"] += 1
    for s in spans.values():
        s.update({k + "_ns": v for k, v in quantiles(s.pop("durs")).items()})

    latencies_ms = [
        (t["done"] - t["queued"]) / 1e6
        for t in req_t.values() if "done" in t and "queued" in t]
    wait_ms = [
        (t["admitted"] - t["queued"]) / 1e6
        for t in req_t.values() if "admitted" in t and "queued" in t]

    gauge_stats = {
        name: {"n": len(vals), "mean": sum(vals) / len(vals),
               "min": min(vals), "max": max(vals),
               "hist": _int_hist(vals)}
        for name, vals in gauges.items()}

    return {
        "spans": spans,
        "counters": counters,
        "gauges": gauge_stats,
        "requests": {
            "phases": requests,
            "prompt_tokens": prompt_tokens,
            "latency_ms": quantiles(latencies_ms),
            "wait_ms": quantiles(wait_ms),
            "n_latencies": len(latencies_ms),
        },
        "train": {
            "steps": len(train_durs),
            "dispatch_ms": quantiles([d / 1e6 for d in train_durs]),
            "nonfinite_skips": train_skips,
            "tokens": train_tokens,
            "last_metrics": last_metrics,
        },
        "jit": {site: {"calls": d["calls"], "misses": d["misses"],
                       "distinct_keys": len(d["keys"])}
                for site, d in jit.items()},
        "meta": meta,
        "defs": defs,
    }


def _int_hist(vals: list[float]) -> dict[str, int]:
    """Occupancy-style histogram: integer-valued gauges bucket exactly."""
    hist: dict[str, int] = {}
    for v in vals:
        key = str(int(v)) if float(v).is_integer() else f"{v:.3g}"
        hist[key] = hist.get(key, 0) + 1
    return dict(sorted(hist.items(), key=lambda kv: _hist_key(kv[0])))


def _hist_key(k: str) -> float:
    try:
        return float(k)
    except ValueError:
        return float("inf")


def reconcile(events: list[dict]) -> list[str]:
    """Lifecycle invariant violations (empty = every request accounted
    for): each queued uid reaches EXACTLY one terminal phase, terminals
    have a queued, and nothing happens to a uid after its terminal."""
    problems: list[str] = []
    queued: set[int] = set()
    terminal: dict[int, str] = {}
    for ev in events:
        if ev.get("kind") != "request":
            continue
        uid, phase = ev.get("uid"), ev.get("name")
        if uid is None:
            if phase != "rejected":
                problems.append(f"request event {phase!r} without a uid")
            continue
        if uid in terminal:
            problems.append(
                f"uid {uid}: {phase!r} after terminal {terminal[uid]!r}")
            continue
        if phase == "queued":
            queued.add(uid)
        elif phase in TERMINAL_PHASES:
            if uid not in queued:
                problems.append(f"uid {uid}: terminal {phase!r} without "
                                "a queued event")
            terminal[uid] = phase
    for uid in sorted(queued - set(terminal)):
        problems.append(f"uid {uid}: queued but never reached a terminal "
                        "phase")
    return problems


def hardware_efficiency(agg: dict) -> dict:
    """Measured-vs-roofline per phase. Needs the engine ``meta`` facts
    (param_count/param_bytes/cache_row_bytes); returns {} without them."""
    meta = agg["meta"]
    needed = ("param_count", "param_bytes", "cache_row_bytes")
    if not all(k in meta for k in needed):
        return {}
    from repro_torch.device import HBM_BW, PEAK_FLOPS_BF16

    param_count = float(meta["param_count"])
    param_bytes = float(meta["param_bytes"])
    row_bytes = float(meta["cache_row_bytes"])
    out: dict[str, dict] = {}

    # Decode: each emitted token costs ~2*params FLOPs and must stream the
    # weights + its KV row from HBM (batching amortizes the weight stream
    # across the group — this floor assumes perfect amortization at the
    # mean measured batch, so the fraction is an upper bound on headroom).
    tokens = agg["counters"].get("tokens_decoded", 0.0)
    dec = agg["spans"].get("decode")
    if dec and tokens:
        batch = max(1.0, tokens / max(1, dec["count"]))
        # Execute-side time (block_ns) when the spans carry the timed_call
        # split — build cost lives in dispatch_ns and must not be billed
        # against the hardware; fall back to wall time otherwise.
        measured_s = (dec["exec_ns"] or dec["total_ns"]) / 1e9 / tokens
        roofline_s = max(2.0 * param_count / PEAK_FLOPS_BF16,
                         (param_bytes / batch + row_bytes) / HBM_BW)
        out["decode"] = _phase(measured_s, roofline_s, tokens)

    # Prefill: 2*params FLOPs per prompt token; one weight stream per call.
    pre = agg["spans"].get("prefill")
    p_tokens = agg["requests"]["prompt_tokens"]
    if pre and p_tokens:
        measured_s = (pre["exec_ns"] or pre["total_ns"]) / 1e9 / p_tokens
        roofline_s = max(2.0 * param_count / PEAK_FLOPS_BF16,
                         param_bytes / max(1, p_tokens / pre["count"])
                         / HBM_BW)
        out["prefill"] = _phase(measured_s, roofline_s, p_tokens)
    return out


def _phase(measured_s: float, roofline_s: float, tokens: float) -> dict:
    return {
        "tokens": tokens,
        "measured_us_per_token": measured_s * 1e6,
        "roofline_us_per_token": roofline_s * 1e6,
        "efficiency": roofline_s / measured_s if measured_s > 0 else 0.0,
    }


def render_report(events: list[dict]) -> str:
    agg = aggregate(events)
    lines = [f"obs report: {len(events)} events"]
    if agg["meta"]:
        facts = ", ".join(f"{k}={agg['meta'][k]}"
                          for k in sorted(agg["meta"]) if k != "plan")
        lines.append(f"  meta: {facts}")
    if agg["spans"]:
        lines.append("  spans (count / total ms / self ms / p50 / p95 / "
                     "p99 ms):")
        for name, s in sorted(agg["spans"].items()):
            split = ""
            if s["exec_ns"]:
                split = (f"  [dispatch {s['dispatch_ns'] / 1e6:.2f} / "
                         f"execute {s['exec_ns'] / 1e6:.2f} ms]")
            lines.append(
                f"    {name:22s} {s['count']:6d}  "
                f"{s['total_ns'] / 1e6:9.2f} {s['self_ns'] / 1e6:9.2f}  "
                f"{s['p50_ns'] / 1e6:8.3f} {s['p95_ns'] / 1e6:8.3f} "
                f"{s['p99_ns'] / 1e6:8.3f}" + split
                + (f"  ({s['errors']} error)" if s["errors"] else ""))
    req = agg["requests"]
    if req["phases"]:
        phases = ", ".join(f"{k}={v}"
                           for k, v in sorted(req["phases"].items()))
        lines.append(f"  requests: {phases}")
        lat = req["latency_ms"]
        lines.append(
            f"  latency queued->done (ms): p50={lat['p50']:.2f} "
            f"p95={lat['p95']:.2f} p99={lat['p99']:.2f} "
            f"(n={req['n_latencies']})")
    for name, g in sorted(agg["gauges"].items()):
        lines.append(f"  gauge {name}: mean={g['mean']:.2f} "
                     f"min={g['min']:.0f} max={g['max']:.0f} "
                     f"hist={g['hist']}")
    if agg["counters"]:
        counts = ", ".join(f"{k}={v:.0f}"
                           for k, v in sorted(agg["counters"].items()))
        lines.append(f"  counters: {counts}")
    if agg["train"]["steps"]:
        tr = agg["train"]
        lines.append(
            f"  train: {tr['steps']} steps, dispatch p50 "
            f"{tr['dispatch_ms']['p50']:.2f} ms, nonfinite_skips "
            f"{tr['nonfinite_skips']:.0f}")
    for site, j in sorted(agg["jit"].items()):
        churn = (" <- plan-hash churn" if j["distinct_keys"] > 1 else "")
        lines.append(f"  jit {site}: {j['calls']} calls, "
                     f"{j['distinct_keys']} distinct plan key(s), "
                     f"{j['misses']} trace miss(es){churn}")
    eff = hardware_efficiency(agg)
    for phase, e in sorted(eff.items()):
        lines.append(
            f"  roofline {phase}: measured {e['measured_us_per_token']:.1f}"
            f" us/token vs modeled floor {e['roofline_us_per_token']:.3f} "
            f"us/token -> {e['efficiency']:.2%} of hardware")
    problems = reconcile(events)
    if problems:
        lines.append(f"  RECONCILE: {len(problems)} problem(s)")
        lines += [f"    {p}" for p in problems]
    elif req["phases"]:
        lines.append("  reconcile: every request reached exactly one "
                     "terminal state")
    return "\n".join(lines)
