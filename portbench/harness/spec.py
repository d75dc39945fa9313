"""The cell's files, found by name.

``BENCHMARK.json`` at the checkout's root lists the cells and metrics. A
cell ``<name>`` is ``portbench/workloads/<name>.json``; its configuration
``portbench/configs/<config>.json``; its traffic kind the module
``portbench/traffic/<kind>.py``; a per-layer metric ``<family>.<suffix>``
is read by ``portbench/metrics/<family>.py``; every port kernel is a
``portbench/kernels/<K>.json``. Adding any of them adds files and entries
and edits none.
"""
from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


class SpecError(ValueError):
    """A file of the benchmark is missing or malformed."""


def _load_json(path: Path) -> dict:
    try:
        return json.loads(path.read_text())
    except FileNotFoundError:
        raise SpecError(f"{path}: no such file") from None
    except json.JSONDecodeError as e:
        raise SpecError(f"{path}: {e}") from None


def load_module(path: Path, name: str):
    """The Python file ``path`` as a fresh module named ``name``."""
    if not path.is_file():
        raise SpecError(f"{path}: no such file")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One cell, with everything found for it."""
    name: str
    entry: dict                 # its BENCHMARK.json entry
    workload: dict              # workloads/<name>.json
    config: dict                # configs/<config>.json
    end_to_end: list            # the BENCHMARK.json metrics it reports
    per_layer: list
    kernels: list               # every kernels/*.json
    bench_dir: Path
    seed: int = 0
    device: str = "cuda"

    def traffic_module(self):
        kind = self.workload["traffic"]
        return load_module(self.bench_dir / "traffic" / f"{kind}.py",
                           f"portbench_traffic_{kind}")

    def metric_reader(self, name: str):
        family = name.split(".", 1)[0]
        return load_module(self.bench_dir / "metrics" / f"{family}.py",
                           f"portbench_metric_{family}")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path | None = None,
              bench_dir: Path | None = None) -> Cell:
    """The cell ``name`` of the ``BENCHMARK.json`` at ``root`` (the
    checkout's root, by default the parent of ``bench_dir``)."""
    bench_dir = Path(bench_dir or BENCH_DIR)
    root = Path(root or bench_dir.parent)
    manifest = _load_json(root / "BENCHMARK.json")
    entries = {w["name"]: w for w in manifest.get("workloads", [])}
    if name not in entries:
        raise SpecError(f"no workload {name!r} in {root / 'BENCHMARK.json'}; "
                        f"cells: {sorted(entries)}")
    entry = entries[name]
    workload = _load_json(bench_dir / "workloads" / f"{name}.json")
    config = _load_json(bench_dir / "configs" / f"{entry['config']}.json")
    if workload.get("config") != entry["config"]:
        raise SpecError(f"workloads/{name}.json names config "
                        f"{workload.get('config')!r}, BENCHMARK.json "
                        f"{entry['config']!r}")
    if workload.get("traffic") != entry["traffic"]:
        raise SpecError(f"workloads/{name}.json names traffic "
                        f"{workload.get('traffic')!r}, BENCHMARK.json "
                        f"{entry['traffic']!r}")
    kernels = [_load_json(p) for p in sorted((bench_dir / "kernels").glob(
        "*.json"))]
    return Cell(name=name, entry=entry, workload=workload, config=config,
                end_to_end=[m for m in manifest["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in manifest["per_layer"]
                           if _reports(m, name)],
                kernels=kernels, bench_dir=bench_dir)
