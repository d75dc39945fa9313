"""``run.py`` refuses to run without a card, with a message, and prints no
result; it also refuses an unknown cell."""
import subprocess
import sys
from pathlib import Path

import pytest
import torch

RUN = Path(__file__).resolve().parents[1] / "run.py"


def _run(*args):
    return subprocess.run([sys.executable, str(RUN), *args],
                          capture_output=True, text=True, timeout=120)


def test_no_card_fails_clearly():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: this checks its absence")
    p = _run("--workload", "af_full.fold_mix", "--seed", "3000000001",
             "--seconds", "1", "--trace", "0")
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "never falls back to the CPU" in p.stderr


def test_unknown_cell_fails():
    p = _run("--workload", "no.such.cell", "--seed", "1", "--seconds", "1",
             "--trace", "0")
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "no workload 'no.such.cell'" in p.stderr
