"""The port's examples (``examples/torch_*.py``, the counterparts of the
reference's four) on the CPU at their smallest arguments: each exits 0 and
prints its key lines. The mini trainer checkpoints, then a rerun resumes
from its newest checkpoint; the long-inference example's per-rank peak
falls as the DAP degree rises."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"


def run_example(name, *args, cwd):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run([sys.executable, str(EXAMPLES / name), *args],
                         env=env, cwd=cwd, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


def test_quickstart(tmp_path):
    out = run_example("torch_quickstart.py", "--device", "cpu", cwd=tmp_path)
    assert "predicted CA coords: (1, 16, 3) distogram: (1, 16, 16, 64)" in out
    assert re.search(r"'loss': \d", out) and "'grad_norm'" in out
    drift = float(re.search(r"coords drift: (\S+)", out).group(1))
    assert drift < 1e-3                     # both legs plain on the CPU
    generated = re.search(r"generated: \[(.*)\]", out).group(1).split(", ")
    assert len(generated) == 8


def test_train_alphafold_mini_checkpoints_and_resumes(tmp_path):
    ck = tmp_path / "ck"
    args = ("--device", "cpu", "--ckpt-every", "1", "--ckpt-dir", str(ck))
    first = run_example("torch_train_alphafold_mini.py", "--steps", "2",
                        *args, cwd=tmp_path)
    assert "config=smoke plan=default device=cpu" in first
    assert "step    1  loss" in first
    assert f"checkpointed: {ck / 'ckpt_00000002.npz'}" in first
    again = run_example("torch_train_alphafold_mini.py", "--steps", "3",
                        *args, cwd=tmp_path)
    assert f"resumed from {ck / 'ckpt_00000002.npz'} at step 2" in again
    assert "step    3  loss" in again and "step    1" not in again


def test_distributed_long_inference(tmp_path):
    out = run_example("torch_distributed_long_inference.py", "--device",
                      "cpu", "--n-res", "16", cwd=tmp_path)
    peaks = {}
    for n, r, peak in re.findall(
            r"ranks=(\d) rank=(\d) n_res=16 per-rank peak activation "
            r"bytes=([\d,]+)", out):
        peaks.setdefault(int(n), []).append(int(peak.replace(",", "")))
    assert {n: len(p) for n, p in peaks.items()} == {1: 1, 2: 2, 4: 4}
    assert max(peaks[4]) < max(peaks[2]) < max(peaks[1])


@pytest.mark.parametrize("chaos", [False, True], ids=["plain", "chaos"])
def test_serve_llm(chaos, tmp_path):
    args = ["--device", "cpu", "--requests", "4", "--max-new", "4"]
    if chaos:
        args.append("--chaos")
    out = run_example("torch_serve_llm.py", *args, cwd=tmp_path)
    assert "arch=qwen2-1.5b served 4 requests, 16 tokens" in out
    assert len(re.findall(r"status=done", out)) == 4
    if chaos:
        assert re.search(r"chaos: injected \d+ faults", out)
        assert "(attempts=2)" in out
