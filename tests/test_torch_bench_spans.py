"""The benchmark's readers of the port's spans (``portbench/harness/
spans.py``; ``portbench/metrics/optimizer_share.py``, ``host_issue_ms.py``,
``optimizer_idle_share.py``) on the CPU: a whole traced run of the tiny
training and fold cells, added in a temporary copy of the benchmark, reports
each new metric finite and in range and stays correct; a program with no
spans (as one without them) gives none of them, and the run still ends;
the device's idle time is put down to the innermost host span open."""
import math
import sys
import time
from contextlib import nullcontext
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.harness import core  # noqa: E402
from portbench.harness.spans import ProfiledSegment  # noqa: E402
from portbench.harness.spec import load_cell  # noqa: E402
from portbench.harness.trace import DeviceOp, TraceSummary  # noqa: E402
from portbench.tests.tiny import tiny_copy  # noqa: E402
from repro_torch.obs import trace as obs  # noqa: E402

NEW = {"tiny.train": {"optimizer_share.train": (0.0, 100.0),
                      "host_issue_ms.train": (0.0, math.inf),
                      "optimizer_idle_share.train": (0.0, 100.0)},
       "tiny.fold": {"host_issue_ms.fold": (0.0, math.inf)}}


def _run(tmp_path, name):
    root = tiny_copy(tmp_path)
    cell = load_cell(name, root=root, bench_dir=root / "portbench")
    cell.device = "cpu"
    cell.seed = 2 ** 31 + 29
    result, _, _ = core.run_cell(cell, 1e-3, True, time.time())
    return result


@pytest.mark.parametrize("name", sorted(NEW))
def test_span_readers_on_a_tiny_cell(tmp_path, name, capsys):
    result = _run(tmp_path, name)
    assert result["correct"], result["compared"]
    for metric, (lo, hi) in NEW[name].items():
        value = result["metrics"][metric]["value"]
        assert math.isfinite(value) and lo < value < hi, (metric, value)
    err = capsys.readouterr().err
    assert "with the tracer on; host seconds an item" in err
    assert ("idle ms an item by innermost span" in err) == (
        name == "tiny.train")


def test_no_spans_no_readings(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(obs.Tracer, "span",
                        lambda self, name, **attrs: nullcontext())
    result = _run(tmp_path, "tiny.train")
    assert result["correct"], result["compared"]
    assert "mfu.train" in result["metrics"]
    assert not set(NEW["tiny.train"]) & set(result["metrics"])
    assert "profiled" not in capsys.readouterr().err   # not run at all


def test_idle_is_put_down_to_the_innermost_span():
    ops = [DeviceOp(f"k{i}", s, e, True, "aten::mul", None)
           for i, (s, e) in enumerate([(1.0, 2.0), (3.0, 4.0), (6.0, 7.0)])]
    seg = ProfiledSegment(TraceSummary(ops=ops, window=(0.0, 10.0), items=1),
                          [(0.5, 9.0, "train.step"),
                           (0.5, 2.5, "train.forward"),
                           (2.5, 5.0, "train.optimizer"),
                           (4.5, 5.0, "train.wait")])
    # Idle: (0, 1), (2, 3), (4, 6), (7, 10).
    assert seg.idle_within(("train.optimizer",)) == pytest.approx(1.5)
    assert seg.idle_within(("train.forward", "train.optimizer")) == \
        pytest.approx(2.5)
    by = seg.idle_by_span()
    assert by == pytest.approx({"train.forward": 1.0,
                                "train.optimizer": 1.0, "train.wait": 0.5,
                                "train.step": 3.0, None: 1.5})
    assert sum(by.values()) == pytest.approx(7.0)
