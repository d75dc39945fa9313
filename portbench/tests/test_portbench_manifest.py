"""``BENCHMARK.json`` and every file of the benchmark parse, use only the
allowed characters, and find one another by name."""
import json
import re
from pathlib import Path

import pytest

from portbench.harness.spec import NAME_RE, UNIT_RE, load_cell
from portbench.reference import costs

BENCH = Path(__file__).resolve().parents[1]
MANIFEST = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
CELLS = [w["name"] for w in MANIFEST["workloads"]]
LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_manifest_keys_and_limits():
    assert set(MANIFEST) == KEYS
    assert MANIFEST["command"] == ["python3", "portbench/run.py"]
    assert MANIFEST["paths"] == ["portbench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len((BENCH.parent / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    names = ([c["name"] for c in MANIFEST["configs"]] + CELLS
             + [m["name"] for m in MANIFEST["end_to_end"]
                + MANIFEST["per_layer"]])
    assert len(names) == len(set(names))
    for n in names:
        assert NAME_RE.match(n), n


def test_metrics_well_formed():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in MANIFEST["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert UNIT_RE.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in MANIFEST["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert UNIT_RE.match(m["unit"]) and LINE.match(m["layer"])
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in CELLS
            assert cell in moved.get("workloads", CELLS), (m["name"], cell)
        assert (BENCH / "metrics" / f"{m['name'].split('.')[0]}.py").is_file()


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found(cell):
    c = load_cell(cell)
    assert c.entry["chips"] == 1 and LINE.match(c.entry["why"])
    assert c.workload["why"] == c.entry["why"]
    assert (BENCH / "traffic" / f"{c.workload['traffic']}.py").is_file()
    assert {m["name"] for m in c.end_to_end} >= {"setup_s", "peak_hbm_gb"}
    assert len(c.end_to_end) >= 2 and c.per_layer
    assert c.workload["limits"] and c.workload["trace_items"] > 0
    assert c.workload["users"]


@pytest.mark.parametrize("cfg", MANIFEST["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    assert cfg["file"] == f"portbench/configs/{cfg['name']}.json"
    data = json.loads((BENCH.parent / cfg["file"]).read_text())
    assert data["source"] == cfg["source"] and LINE.match(cfg["source"])
    assert data["reduced"] == cfg["reduced"]
    for key in cfg["reduced"]:
        assert NAME_RE.match(key) and key in data["published"]
        assert not key.endswith(("_dim", "_rank")) and "head" not in key
    assert data["assumed"] and data["deployment"]


@pytest.mark.parametrize("path", sorted((BENCH / "kernels").glob("*.json")),
                         ids=lambda p: p.stem)
def test_kernel_files(path):
    k = json.loads(path.read_text())
    assert k["name"] == path.stem and NAME_RE.match(k["name"])
    assert k["symbols"] and k["work"] in costs.WORK
    assert k["site"] in costs.WORK
