"""The window's arithmetic on a fake clock and fake device intervals: a
rate over whole items, the 90th percentile over all requests, the idle
share from intervals, and the loop that starts no item after the window
but finishes the cycle it is in."""
import json

import pytest

from portbench.harness import core
from portbench.harness.spec import load_cell
from portbench.harness.stats import gaps, percentile, rate, union_length
from portbench.harness.trace import DeviceOp, TraceSummary
from portbench.tests.tiny import add_json, tiny_copy


def test_rate_over_whole_items():
    assert rate(10.0, 100.0, 104.0) == 2.5
    with pytest.raises(ValueError):
        rate(1.0, 5.0, 5.0)


@pytest.mark.parametrize("values,p90", [
    (list(range(1, 11)), 9), (list(range(1, 21)), 18), ([3.0], 3.0),
    ([1, 1, 1, 1, 1, 1, 1, 1, 2, 2], 2), ([5, 1, 4, 2, 3], 5)])
def test_p90_over_all_requests(values, p90):
    assert percentile(values, 90) == p90


def test_union_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (6.0, 9.0)]
    assert union_length(iv, 0.0, 8.0) == pytest.approx(5.0)
    assert gaps(iv, 0.0, 8.0) == [(2.0, 3.0), (4.0, 6.0)]
    assert gaps(iv, -1.0, 10.0)[0] == (-1.0, 0.0)


def test_idle_share_and_breakdown():
    ops = [DeviceOp("a", 0.0, 1.0, True, "aten::mm", None),
           DeviceOp("b", 1.5, 2.0, True, "aten::copy_", None),
           DeviceOp("layer_norm_kernel<1>", 3.0, 3.5, True, None, "K1"),
           DeviceOp("Memcpy HtoD", 3.5, 4.0, False, None, None)]
    t = TraceSummary(ops=ops, window=(0.0, 5.0), items=2)
    assert t.busy_s() == pytest.approx(2.5)
    assert len(t.kernels()) == 3
    bd = t.breakdown()
    assert dict(bd["device_ops"]) == {"matrix products": 1.0,
                                      "copies and casts": 0.5,
                                      "K1 (port)": 0.5}
    assert sum(v for _, v in bd["idle_gaps"]) == pytest.approx(2.5)


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


FAKE_SESSION = (
    "from portbench.harness import core\n"
    "class Session:\n"
    "    def __init__(self, cell):\n"
    "        self.clock = core._now\n"
    "        self.cycle = cell.workload['params'].get('cycle')\n"
    "        self.k = 0\n"
    "    def setup(self):\n        pass\n"
    "    def item(self):\n"
    "        self.clock.t += 0.3\n"
    "        self.k += 1\n"
    "        return {'work': 2.0, 'latency_s': 0.3, 'done': self.clock.t,"
    " 'kind': 0}\n"
    "    def mid_cycle(self):\n"
    "        return bool(self.cycle) and self.k % self.cycle != 0\n"
    "    def drain(self):\n        pass\n"
    "    def failed(self, window):\n        return 0\n"
    "    def end_to_end(self, window):\n"
    "        from portbench.harness.stats import rate\n"
    "        w = sum(r['work'] for r in window.records)\n"
    "        return {'fold_residues_per_s': rate(w, window.t_start,"
    " window.t_done), 'fold_latency_p90_s': 0.3}\n"
    "    def release(self):\n        pass\n"
    "    def check(self, control=None):\n        return {'gap': 0.0}\n")


def _clock_cell(tmp_path, params):
    root = tiny_copy(tmp_path)
    bench = root / "portbench"
    (bench / "traffic" / "fake_clock.py").write_text(FAKE_SESSION)
    add_json(bench / "workloads" / "tiny.clock.json",
             {"name": "tiny.clock", "config": "tiny", "traffic": "fake_clock",
              "why": "tests", "users": "tests", "params": params,
              "trace_items": 1, "limits": {"gap": 0.1}})
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["workloads"].append({"name": "tiny.clock", "config": "tiny",
                                  "traffic": "fake_clock", "chips": 1,
                                  "why": "tests"})
    for m in manifest["end_to_end"]:
        if "fold_residues_per_s" == m["name"] or "fold_latency" in m["name"]:
            m["workloads"].append("tiny.clock")
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    cell = load_cell("tiny.clock", root=root, bench_dir=bench)
    cell.device = "cpu"
    return cell


def test_window_starts_no_item_after_its_seconds(tmp_path, monkeypatch):
    cell = _clock_cell(tmp_path, {})
    monkeypatch.setattr(core, "_now", FakeClock())
    result, rows, _ = core.run_cell(cell, 1.0, False, 0.0)
    # Items start at 0, 0.3, 0.6 and 0.9 s: four, the last done at 1.2 s.
    assert result["attempted"] == 4 and result["correct"]
    assert result["metrics"]["fold_residues_per_s"]["value"] == \
        pytest.approx(8.0 / 1.2)
    assert list(result)[-1] == "compared"
    assert rows == [["gap", 0.0, 0.1]]


@pytest.mark.parametrize("seconds,items", [(1.0, 6), (1e-3, 3), (1.75, 6),
                                           (1.81, 9)])
def test_window_ends_on_a_whole_cycle(tmp_path, monkeypatch, seconds, items):
    cell = _clock_cell(tmp_path, {"cycle": 3})
    monkeypatch.setattr(core, "_now", FakeClock())
    result, _, _ = core.run_cell(cell, seconds, False, 0.0)
    assert result["attempted"] == items
    assert result["metrics"]["fold_residues_per_s"]["value"] == \
        pytest.approx(2.0 / 0.3)


def test_launcher_is_the_innermost_op_open():
    from portbench.harness.trace import _launchers

    aten = [(0.0, 10.0, "aten::outer"), (1.0, 2.0, "aten::copy_"),
            (3.0, 6.0, "aten::mm"), (4.0, 5.0, "aten::inner"),
            (7.0, 9.0, "aten::other_thread")]
    launch = {1: 1.5, 2: 3.5, 3: 4.5, 4: 5.5, 5: 6.5, 6: 8.0, 7: 11.0}
    assert _launchers(aten, launch) == {
        1: "aten::copy_", 2: "aten::mm", 3: "aten::inner", 4: "aten::mm",
        5: "aten::outer", 6: "aten::other_thread", 7: None}


def test_metric_readers_on_a_fake_trace():
    from collections import Counter

    from portbench.harness.core import Reading, Window
    from portbench.harness.spec import load_cell
    from portbench.reference.costs import PEAK_FLOPS, bound_s, site_work

    cell = load_cell("af_full.fold_mix")
    ln = ("layer_norm", tuple(sorted({"n": 1 << 20, "c": 128,
                                      "x_bytes": 2}.items())))

    class Session:
        def work_of(self, kind):
            return 1e12, Counter({ln: 10})

    ops = [DeviceOp("layer_norm_kernel", 0.0, 0.004, True, None, "K1"),
           DeviceOp("elementwise", 0.004, 0.005, True, "aten::copy_", None),
           DeviceOp("gemm", 0.006, 0.010, True, "aten::mm", None)]
    trace = TraceSummary(ops=ops, window=(0.0, 0.020), items=2)
    window = Window(0.0, 0.05, [{"kind": 256}] * 4)
    reading = Reading(cell, Session(), window, trace, [{"kind": 256}] * 2)
    read = lambda name: cell.metric_reader(name).read(reading)  # noqa: E731
    assert read("kernel_launches.fold") == 1.5
    assert read("copy_cast_share.fold") == pytest.approx(100 * 0.001 / 0.009)
    # 0.009 s busy over 2 traced items; 4 in the window, 0.05 s long.
    assert read("device_idle_share.fold") == pytest.approx(
        100 * (1 - 0.018 / 0.05))
    assert read("mfu.fold") == pytest.approx(100 * 4e12 / (0.05 * PEAK_FLOPS))
    bound = 2 * 10 * bound_s(*site_work("layer_norm", dict(ln[1])))
    assert read("port_kernels_roofline.fold") == pytest.approx(
        100 * bound / 0.004)
