"""Spans on the port's AlphaFold path (``repro_torch.obs``), at SMOKE
widths on the CPU: the span tree of one traced ``FastFold.serve`` and of
one traced training step; a fold and a step traced equal to untraced ones
to the bit, with no tensor among the spans' attributes; the profiler
ranges the spans open while ``torch.profiler`` records (and none with no
tracer); the ``kernels.build`` span; ``annotate``."""
import dataclasses

import pytest
import torch

from repro_torch.configs import SMOKE
from repro_torch.data import protein_batches
from repro_torch.exec import FastFold
from repro_torch.kernels import _build
from repro_torch.layers.params import tree_leaves
from repro_torch.obs import annotate, use_tracer, validate_events
from repro_torch.obs import trace as obs
from repro_torch.train import make_train_step
from torch_parity import one_torch_thread  # noqa: F401

CFG = dataclasses.replace(SMOKE, compute_dtype=torch.float32)
PASS = ["alphafold.embed", "evoformer.stack", "structure.module",
        "alphafold.heads"]
PASSES = CFG.n_recycle + 1


@pytest.fixture(scope="module")
def ff():
    return FastFold(CFG, device="cpu")


@pytest.fixture(scope="module")
def params(ff):
    return ff.init(0)


def _batch():
    return next(protein_batches(batch=1, n_seq=6, n_res=12,
                                seed=1)).as_dict()


def _spans(tr):
    return [e for e in tr.events if e["kind"] == "span"]


def _children(spans, parent):
    return sorted((e for e in spans if e["parent_id"] == parent["span_id"]),
                  key=lambda e: e["t_start_ns"])


def _root(spans):
    (root,) = [e for e in spans if e["parent_id"] is None]
    return root


def _step(ff, params):
    init, step = make_train_step(ff.loss_fn)
    return step(init(params), _batch(), torch.Generator().manual_seed(0))


def _check_passes(spans, passes, grad_last):
    assert [p["attrs"] for p in passes] == [
        {"index": i, "last": int(i == PASSES - 1),
         "grad": int(grad_last and i == PASSES - 1)} for i in range(PASSES)]
    for p in passes:
        kids = _children(spans, p)
        assert [e["name"] for e in kids] == PASS
        assert kids[1]["attrs"] == {
            "n_blocks": CFG.evoformer.n_blocks,
            "remat": int(grad_last and p is passes[-1])}


def test_annotate_adds_to_the_innermost_open_span():
    annotate(x=1)                                # unscoped: nothing
    with use_tracer() as tr:
        annotate(x=1)                            # no span open: nothing
        with obs.span("outer", a=1):
            with obs.span("inner"):
                annotate(b=2)
            annotate(c=3)
    inner, outer = tr.events
    assert (inner["name"], inner["attrs"]) == ("inner", {"b": 2})
    assert (outer["name"], outer["attrs"]) == ("outer", {"a": 1, "c": 3})


def test_serve_span_tree(ff, params, one_torch_thread):  # noqa: F811
    with use_tracer() as tr:
        ff.serve(params, [_batch()])
    assert not validate_events(tr.events_resolved())
    spans = _spans(tr)
    root = _root(spans)
    assert root["name"] == "fastfold.serve"
    assert root["attrs"] == {"batch": 1, "n_seq": 6, "n_res": 12}
    kids = _children(spans, root)
    assert [e["name"] for e in kids] == (["alphafold.plan"]
                                         + ["alphafold.pass"] * PASSES)
    plan = kids[0]["attrs"]
    assert {"inference_chunk", "opm_chunk", "attn_kv_tile", "tri_k_tile",
            "opm_s_tile", "est_bytes", "budget_bytes", "fits"} == set(plan)
    assert plan["fits"] == 1 and 0 < plan["est_bytes"] <= plan["budget_bytes"]
    _check_passes(spans, kids[1:], grad_last=False)
    assert len(spans) == 2 + PASSES * (1 + len(PASS))


def test_train_step_span_tree(ff, params, one_torch_thread):  # noqa: F811
    with use_tracer() as tr:
        _step(ff, params)
    assert not validate_events(tr.events_resolved())
    spans = _spans(tr)
    root = _root(spans)
    assert root["name"] == "train.step"
    assert root["attrs"] == {"leaves": len(tree_leaves(params))}
    kids = _children(spans, root)
    assert [e["name"] for e in kids] == ["train.forward", "train.backward",
                                         "train.clip", "train.optimizer"]
    (wait,) = [e for e in spans if e["name"] == "train.wait"]
    assert wait["parent_id"] == kids[3]["span_id"]
    assert not _children(spans, kids[1])          # nothing in the backward
    fwd = _children(spans, kids[0])
    assert [e["name"] for e in fwd] == (["alphafold.plan"]
                                        + ["alphafold.pass"] * PASSES)
    _check_passes(spans, fwd[1:], grad_last=True)


@pytest.mark.parametrize("kind", ["fold", "step"])
def test_traced_equals_untraced_and_attrs_hold_no_tensor(
        ff, params, kind, one_torch_thread):  # noqa: F811
    def run():
        if kind == "fold":
            (out,) = ff.serve(params, [_batch()])
            return [out[k] for k in ("distogram_logits", "msa_logits",
                                     "coords", "pair")]
        state, m = _step(ff, params)
        return (tree_leaves(state.params) + tree_leaves(state.opt_state.m)
                + tree_leaves(state.opt_state.v)
                + [m["loss"], m["grad_norm"], state.opt_state.step])

    plain = run()
    with use_tracer() as tr:
        traced = run()
    assert len(plain) == len(traced)
    assert all(torch.equal(a, b) for a, b in zip(plain, traced))
    spans = _spans(tr)
    assert spans
    for e in spans:
        assert all(type(v) in (int, float, str) for v in e["attrs"].values()), e


def test_profiler_ranges_follow_the_spans(ff, params,
                                          one_torch_thread):  # noqa: F811
    act = [torch.profiler.ProfilerActivity.CPU]
    with use_tracer() as tr:
        with torch.profiler.profile(activities=act) as prof:
            ff.serve(params, [_batch()])
    spans = sorted(_spans(tr), key=lambda e: e["t_start_ns"])
    names = {e["name"] for e in spans}
    ranges = sorted((e.start_ns(), e.end_ns(), e.name())
                    for e in prof.profiler.kineto_results.events()
                    if e.name() in names)
    assert [r[2] for r in ranges] == [e["name"] for e in spans]
    where = {e["span_id"]: r for e, r in zip(spans, ranges)}
    for e in spans:
        if e["parent_id"] is not None:
            outer, inner = where[e["parent_id"]], where[e["span_id"]]
            assert outer[0] <= inner[0] and inner[1] <= outer[1], (e, outer)
    # The same fold with no tracer: no range of those names.
    with torch.profiler.profile(activities=act) as prof:
        ff.serve(params, [_batch()])
    assert not [e.name() for e in prof.profiler.kineto_results.events()
                if e.name() in names]


def test_kernels_build_span_names_the_sources(tmp_path, monkeypatch):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\nwhile [ \"$1\" != -o ]; do shift; done\n"
                    "touch \"$2\"\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(fake))
    with use_tracer() as tr:
        _build.build_all()
    (span,) = _spans(tr)
    assert span["name"] == "kernels.build" and span["status"] == "ok"
    assert span["attrs"]["kernels"].split(",") == list(_build.SIGNATURES)
    with use_tracer() as tr:                      # all built: no span
        _build.build_all()
    assert not _spans(tr)
