"""The port's observability package (``repro_torch.obs``): the mirror of
the reference's tests in ``tests/test_obs.py`` that need no serving engine
(unscoped hooks, scoping, spans, counters and gauges, ``define``,
``jit_entry``, the JSONL round trip with lazily resolved 0-d tensors, the
validators, ``timed_call``'s device split, and ``instrument_train_step``:
unscoped it is the bare step bit for bit, scoped it emits one schema-valid
``train_step`` event a step), plus the port against the reference: the same
schema, and streams the reference's validator accepts."""
import io
import json

import numpy as np
import pytest
import torch

from repro.obs import events as j_events
from repro_torch import device as card
from repro_torch.exec.plan import preset
from repro_torch.obs import (
    Tracer,
    aggregate,
    current_tracer,
    hardware_efficiency,
    quantiles,
    read_jsonl,
    reconcile,
    render_report,
    use_tracer,
    validate_events,
)
from repro_torch.obs import events as t_events
from repro_torch.obs import trace as obs
from repro_torch.obs.__main__ import main as obs_main
from repro_torch.train import instrument_train_step, make_train_step


# ---------------------------------------------------------------------------
# Tracer core and schema validation (tests/test_obs.py)
# ---------------------------------------------------------------------------


def test_unscoped_hooks_are_noops():
    assert current_tracer() is None
    with obs.span("free"):                       # null context, no tracer
        pass
    obs.emit("gauge", "nobody")
    obs.count("nothing")
    obs.gauge("nothing", 1)
    assert obs.timed_call("direct", lambda x: x + 1, 41) == 42
    assert current_tracer() is None


def test_use_tracer_scoping_nested_and_exception_safe():
    with use_tracer() as outer:
        assert current_tracer() is outer
        inner_tr = Tracer()
        with use_tracer(inner_tr):
            assert current_tracer() is inner_tr
        assert current_tracer() is outer
        with pytest.raises(RuntimeError, match="boom"):
            with use_tracer():
                raise RuntimeError("boom")
        assert current_tracer() is outer         # restored despite the raise
    assert current_tracer() is None
    with pytest.raises(TypeError):
        with use_tracer("not a tracer"):
            pass


def test_span_nesting_parent_ids_and_error_status():
    tr = Tracer()
    with tr.span("outer"):
        with tr.span("mid"):
            with tr.span("leaf"):
                pass
        with pytest.raises(ValueError, match="bad"):
            with tr.span("broken"):
                raise ValueError("bad")
        with tr.span("after"):                   # stack restored post-raise
            pass
    spans = {e["name"]: e for e in tr.events if e["kind"] == "span"}
    assert spans["outer"]["parent_id"] is None
    assert spans["mid"]["parent_id"] == spans["outer"]["span_id"]
    assert spans["leaf"]["parent_id"] == spans["mid"]["span_id"]
    assert spans["broken"]["parent_id"] == spans["outer"]["span_id"]
    assert spans["after"]["parent_id"] == spans["outer"]["span_id"]
    assert spans["broken"]["status"] == "error"
    assert spans["after"]["status"] == "ok"
    # children close before parents, and every span's interval nests inside
    # its parent's
    assert tr.events[-1]["name"] == "outer"
    for name in ("mid", "leaf", "broken", "after"):
        ev, parent = spans[name], spans[
            "outer" if name != "leaf" else "mid"]
        assert ev["t_start_ns"] >= parent["t_start_ns"]
        assert ev["t_start_ns"] + ev["dur_ns"] <= \
            parent["t_start_ns"] + parent["dur_ns"]
    assert not validate_events(tr.events)


def test_counters_accumulate_and_gauges_record():
    tr = Tracer()
    tr.count("tokens")
    tr.count("tokens", 2.0)
    tr.gauge("depth", 7, step=1)
    assert tr.counters == {"tokens": 3.0}
    counter_events = [e for e in tr.events if e["kind"] == "counter"]
    assert [e["value"] for e in counter_events] == [1.0, 3.0]
    (g,) = [e for e in tr.events if e["kind"] == "gauge"]
    assert g["value"] == 7 and g["attrs"]["step"] == 1


def test_define_interns_values_deterministically():
    tr = Tracer()
    a = preset("default").to_dict()
    b = preset("oracle").to_dict()
    assert tr.define("plan", a) == "plan:0"
    assert tr.define("plan", b) == "plan:1"
    assert tr.define("plan", a) == "plan:0"      # stable on re-intern
    defs = [e for e in tr.events if e["kind"] == "def"]
    assert [d["name"] for d in defs] == ["plan:0", "plan:1"]  # emitted once
    assert defs[0]["value"] == a


def test_jit_entry_counts_plan_hash_churn():
    tr = Tracer()
    assert tr.jit_entry("decode", "plan:0") is True     # expected trace
    assert tr.jit_entry("decode", "plan:0") is False    # hit
    assert tr.jit_entry("decode", "plan:1") is True     # churn!
    assert tr.jit_entry("prefill", "plan:0") is True    # new site: expected
    assert tr.counters.get("trace_cache_miss") == 1.0
    assert [e["cache"] for e in tr.events if e["kind"] == "jit_entry"] == \
        ["miss", "hit", "miss", "miss"]


def test_validator_rejects_malformed_events():
    ok = {"seq": 0, "t_ns": 1, "kind": "gauge", "name": "g", "value": 1,
          "attrs": {}}
    assert not validate_events([ok])
    assert validate_events([{**ok, "kind": "nope"}])        # unknown kind
    assert validate_events([{**ok, "extra": 1}])            # undeclared field
    bad_phase = {"seq": 0, "t_ns": 1, "kind": "request", "name": "vanished",
                 "uid": 1, "attrs": {}}
    assert validate_events([bad_phase])
    missing = dict(ok)
    del missing["value"]
    assert validate_events([missing])
    assert validate_events([ok, ok])                        # seq not increasing


def test_quantiles_and_reconcile_units():
    assert quantiles([]) == {"p50": 0.0, "p95": 0.0, "p99": 0.0}
    q = quantiles(list(range(1, 101)))
    assert q["p50"] == 51.0 and q["p95"] == 95.0 and q["p99"] == 99.0

    def req(seq, phase, uid):
        return {"seq": seq, "t_ns": seq, "kind": "request", "name": phase,
                "uid": uid, "attrs": {}}

    good = [req(0, "queued", 1), req(1, "admitted", 1), req(2, "done", 1)]
    assert not reconcile(good)
    assert reconcile([req(0, "queued", 1)])                 # no terminal
    assert reconcile([req(0, "done", 1)])                   # never queued
    double = good + [req(3, "failed", 1)]                   # two terminals
    assert reconcile(double)


def test_timed_call_splits_dispatch_from_the_device_wait(monkeypatch):
    """The port's ``timed_call`` waits on each CUDA device its tensor
    outputs lie on, once, and on none when they all lie on the CPU."""
    synced = []
    monkeypatch.setattr(obs, "_synchronize", synced.append)
    tr = Tracer()

    class OnCard:                      # a tensor's device, without a card
        device = torch.device("cuda", 0)

    out = tr.timed_call("cpu", lambda x: (x + 1, {"y": x * 2}), torch.ones(3))
    assert torch.equal(out[0], torch.full((3,), 2.0))
    assert synced == []
    tr.timed_call("card", lambda: [OnCard(), (OnCard(), torch.ones(1))])
    assert synced == [torch.device("cuda", 0)]
    for ev in tr.events:
        assert ev["attrs"]["dispatch_ns"] >= 0
        assert ev["attrs"]["block_ns"] >= 0
        assert ev["dur_ns"] >= ev["attrs"]["dispatch_ns"]
    assert not validate_events(tr.events)
    assert obs._cuda_devices({"a": OnCard(), "b": [OnCard()]}) == [
        torch.device("cuda", 0)]


def test_jsonl_round_trip_resolves_lazy_values(tmp_path):
    tr = Tracer()
    loss = torch.tensor(1.5)                         # 0-d tensor: lazy
    ev0 = tr.emit("train_step", "train_step", step=1, dur_ns=10, tokens=None,
                  metrics={"loss": loss, "grid": torch.ones(2)})
    assert ev0["metrics"]["loss"] is loss            # unresolved at emit
    path = tmp_path / "events.jsonl"
    assert tr.dump_jsonl(str(path)) == 1
    (ev,) = read_jsonl(str(path))
    assert ev["metrics"]["loss"] == 1.5              # plain float now
    assert isinstance(ev["metrics"]["grid"], str)    # not a scalar: repr
    assert not validate_events([ev])
    buf = io.StringIO()
    tr.dump_jsonl(buf)
    assert json.loads(buf.getvalue()) == ev
    assert obs_main(["report", str(path), "--strict"]) == 0


# ---------------------------------------------------------------------------
# Train-loop instrumentation (tests/test_obs.py)
# ---------------------------------------------------------------------------


def _toy_setup(guard=True):
    def loss_fn(params, batch, rng):
        pred = batch["x"] @ params["w"]
        return torch.mean((pred - batch["y"]) ** 2), {}

    init_state, train_step = make_train_step(
        loss_fn, base_lr=1e-2, warmup_steps=2, total_steps=10,
        guard_nonfinite=guard)
    params = {"w": torch.ones(4, 2)}
    rng = np.random.default_rng(0)
    batch = {"x": torch.as_tensor(rng.normal(size=(8, 4)), dtype=torch.float32),
             "y": torch.as_tensor(rng.normal(size=(8, 2)), dtype=torch.float32)}
    return init_state(params), train_step, batch


def test_metrics_key_contract_is_never_ragged():
    for guard in (True, False):
        state, step, batch = _toy_setup(guard=guard)
        _, metrics = step(state, batch)
        assert {"loss", "grad_norm", "lr", "nonfinite_skips"} <= set(metrics)
        assert float(metrics["nonfinite_skips"]) == 0.0
        assert metrics["nonfinite_skips"].device == metrics["grad_norm"].device


def test_unscoped_instrumented_train_step_is_bit_identical():
    state_a, step, batch = _toy_setup()
    state_b = state_a
    istep = instrument_train_step(step, tokens_per_step=8)
    assert current_tracer() is None
    for _ in range(3):
        state_a, ma = step(state_a, batch)
        state_b, mb = istep(state_b, batch)
    assert torch.equal(state_a.params["w"], state_b.params["w"])
    assert torch.equal(state_a.opt_state.m["w"], state_b.opt_state.m["w"])
    assert float(ma["loss"]) == float(mb["loss"])


def test_instrumented_train_step_emits_schema_valid_events():
    state, step, batch = _toy_setup()
    istep = instrument_train_step(step, tokens_per_step=8)
    with use_tracer() as tr:
        for _ in range(4):
            state, _ = istep(state, batch)
    raw = [e for e in tr.events if e["kind"] == "train_step"]
    assert len(raw) == 4 and [e["step"] for e in raw] == [1, 2, 3, 4]
    assert all(isinstance(v, torch.Tensor) for e in raw
               for v in e["metrics"].values())      # recorded unresolved
    events = tr.events_resolved()
    assert not validate_events(events)
    assert not j_events.validate_events(events)     # the reference's schema
    agg = aggregate(events)
    assert agg["train"]["steps"] == 4 and agg["train"]["tokens"] == 32.0
    assert set(events[-1]["metrics"]) == {"loss", "grad_norm",
                                          "nonfinite_skips"}
    assert "train: 4 steps" in render_report(events)


# ---------------------------------------------------------------------------
# The port against the reference
# ---------------------------------------------------------------------------


def test_schema_matches_the_reference():
    assert t_events.SCHEMA_VERSION == j_events.SCHEMA_VERSION
    assert t_events.KINDS == j_events.KINDS
    assert t_events.REQUEST_PHASES == j_events.REQUEST_PHASES


def test_hardware_efficiency_uses_the_cards_peaks():
    """The roofline floor of a decode phase from the H100's published bf16
    peak and HBM bandwidth (``repro_torch.device``), not another chip's."""
    agg = aggregate([
        {"seq": 0, "t_ns": 0, "kind": "meta", "name": "run",
         "attrs": {"param_count": 1e9, "param_bytes": 2e9,
                   "cache_row_bytes": 1e6}},
        {"seq": 1, "t_ns": 1, "kind": "counter", "name": "tokens_decoded",
         "delta": 4.0, "value": 4.0, "attrs": {}},
        {"seq": 2, "t_ns": 2, "kind": "span", "name": "decode", "span_id": 0,
         "parent_id": None, "t_start_ns": 0, "dur_ns": 4e6, "status": "ok",
         "attrs": {}}])
    eff = hardware_efficiency(agg)["decode"]
    floor = max(2e9 / card.PEAK_FLOPS_BF16, (2e9 / 4 + 1e6) / card.HBM_BW)
    assert eff["roofline_us_per_token"] == pytest.approx(floor * 1e6)
    assert eff["measured_us_per_token"] == pytest.approx(1e3)
    assert card.PEAK_FLOPS_BF16 == 989e12 and card.HBM_BW == 3.35e12
