"""The check of ``correct``, driven through a whole run on the CPU (the
harness's look for a card skipped) at a tiny configuration under the
cells' own limits: a sound run of the port's fp32 plain path is correct,
and each fault the cells can have makes it false, as does the control
(the reference in fp8 put in the program's place).

Faults: a training step that returns its state unchanged; an answer
altered where it is produced (a fold's distogram logits, or its
coordinates, which the structure module's stage check catches). The cells have
batch 1 and one chip, so no half-batch or cross-chip fault applies."""
import json
import time

import pytest
import torch

from portbench.harness import core
from portbench.harness.spec import load_cell
from portbench.tests.tiny import BENCH, tiny_copy

LIKE = {"tiny.train": "af_full.train_initial", "tiny.fold": "af_full.fold_mix"}


def _cell(tmp_path, name):
    root = tiny_copy(tmp_path)
    cell = load_cell(name, root=root, bench_dir=root / "portbench")
    limits = json.loads((BENCH / "workloads" / f"{LIKE[name]}.json")
                        .read_text())["limits"]
    assert cell.workload["limits"] == limits
    cell.device = "cpu"
    cell.seed = 2 ** 31 + 17
    return cell


def _run(cell, control=None):
    # The shortest window: one item, and for the fold cell the rest of its
    # first cycle, whose requests are the ones compared.
    result, _, _ = core.run_cell(cell, 1e-3, False, time.time(),
                                 control=control)
    return result


@pytest.mark.parametrize("name", sorted(LIKE))
def test_sound_run_is_correct(tmp_path, name):
    result = _run(_cell(tmp_path, name))
    assert result["correct"], result["compared"]
    assert result["attempted"] > 0 and result["failed"] == 0


@pytest.mark.parametrize("name", sorted(LIKE))
def test_control_is_not_correct(tmp_path, name):
    result = _run(_cell(tmp_path, name), control="fp8")
    assert not result["correct"], result["compared"]


def test_unchanged_state_is_not_correct(tmp_path, monkeypatch):
    import repro_torch.train

    real = repro_torch.train.make_train_step

    def frozen(*args, **kwargs):
        init, step = real(*args, **kwargs)

        def same_state(state, batch, rng=None):
            _, metrics = step(state, batch, rng)
            return state, metrics

        return init, same_state

    monkeypatch.setattr(repro_torch.train, "make_train_step", frozen)
    result = _run(_cell(tmp_path, "tiny.train"))
    assert not result["correct"]
    assert result["compared"]["delta_gap"]["value"] == pytest.approx(1.0)


def test_altered_answer_is_not_correct(tmp_path, monkeypatch):
    from repro_torch.exec import FastFold

    real = FastFold.serve

    def altered(self, params, batches, plans=None):
        outs = real(self, params, batches, plans=plans)
        for out in outs:
            out["distogram_logits"] = -out["distogram_logits"]
        return outs

    monkeypatch.setattr(FastFold, "serve", altered)
    result = _run(_cell(tmp_path, "tiny.fold"))
    assert not result["correct"]
    assert result["compared"]["dist_gap"]["value"] > 1.0


def test_altered_coordinates_are_not_correct(tmp_path, monkeypatch):
    from repro_torch.exec import FastFold

    real = FastFold.serve

    def moved(self, params, batches, plans=None):
        outs = real(self, params, batches, plans=plans)
        for out in outs:
            out["coords"] = out["coords"] * 1.01
        return outs

    monkeypatch.setattr(FastFold, "serve", moved)
    result = _run(_cell(tmp_path, "tiny.fold"))
    assert not result["correct"]
    gap = result["compared"]["structure_gap"]
    assert gap["value"] > gap["limit"]
    assert result["compared"]["dist_gap"]["value"] <= \
        result["compared"]["dist_gap"]["limit"]
