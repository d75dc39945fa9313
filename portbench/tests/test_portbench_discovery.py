"""A configuration, a cell, a traffic kind, a port kernel and a per-layer
metric added as new files (and entries in ``BENCHMARK.json``) are found
without editing any file that is there."""
import json

from portbench.harness.spec import load_cell
from portbench.tests.tiny import add_json, tiny_copy


def test_new_cell_and_config_found(tmp_path):
    root = tiny_copy(tmp_path)
    for name in ("tiny.train", "tiny.fold"):
        cell = load_cell(name, root=root, bench_dir=root / "portbench")
        assert cell.config["name"] == "tiny" and cell.config["n_blocks"] == 2
        assert cell.traffic_module().Session
        assert {m["name"] for m in cell.per_layer} >= {"mfu.train"} or \
            {m["name"] for m in cell.per_layer} >= {"mfu.fold"}


def test_new_metric_kernel_and_traffic_found(tmp_path):
    root = tiny_copy(tmp_path)
    bench = root / "portbench"
    (bench / "metrics" / "items_traced.py").write_text(
        "def read(reading):\n    return float(len(reading.traced))\n")
    (bench / "traffic" / "idle.py").write_text(
        "class Session:\n    def __init__(self, cell):\n        pass\n")
    add_json(bench / "kernels" / "K9.json",
             {"name": "K9", "port_kernel": "new", "symbols": ["k9_kernel"],
              "site": "layer_norm", "work": "layer_norm"})
    add_json(bench / "workloads" / "tiny.idle.json",
             {"name": "tiny.idle", "config": "tiny", "traffic": "idle",
              "why": "tests", "users": "tests", "params": {},
              "trace_items": 1, "limits": {}})
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["workloads"].append({"name": "tiny.idle", "config": "tiny",
                                  "traffic": "idle", "chips": 1,
                                  "why": "tests"})
    manifest["per_layer"].append({
        "name": "items_traced.idle", "unit": "items", "better": "higher",
        "source": "program_counter", "layer": "entry and plan",
        "moves": "setup_s", "workloads": ["tiny.idle"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    cell = load_cell("tiny.idle", root=root, bench_dir=bench)
    assert [m["name"] for m in cell.per_layer] == ["items_traced.idle"]
    assert cell.metric_reader("items_traced.idle").read(
        type("R", (), {"traced": [1, 2]})()) == 2.0
    assert "K9" in [k["name"] for k in cell.kernels]
    assert cell.traffic_module().Session(cell) is not None
