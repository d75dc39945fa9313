"""On a card: each cell runs once through ``run.py`` with a short window
and prints a correct result line; a fold cell's window still finishes its
first cycle, whose requests are the ones compared. Skips where there is
no CUDA device."""
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
CELLS = [w["name"] for w in json.loads(
    (BENCH.parent / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                        cell, "--seed", "2147483659", "--seconds", "3",
                        "--trace", "0"], capture_output=True, text=True,
                       timeout=1200, cwd=BENCH.parent)
    assert p.returncode == 0, p.stderr[-3000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"], result["compared"]
    assert result["device"]["platform"] == "gpu"
