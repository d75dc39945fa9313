"""Port hygiene and device policy: the PyTorch port imports no JAX and
nothing of the JAX package, runs on the card unless asked for the CPU, sends
CPU tensors to the plain versions without touching a kernel, and builds its
kernels with nvcc for sm_90a into a directory git ignores."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import SMOKE
from repro_torch.data import protein_batches
from repro_torch.exec import FastFold
from repro_torch.kernels import _build, ops
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.fused_elementwise import bias_sigmoid_mul_cuda
from repro_torch.kernels.layer_norm import layer_norm_cuda

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "scripts" / "torch_profile_serve.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_package_imports_without_triton_nvcc_or_jax():
    """Every module imports in a fresh interpreter whose PATH holds no nvcc
    and where triton cannot be imported, and leaves JAX unloaded."""
    mods = sorted("repro_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
                  for p in PORT.rglob("*.py") if p.name != "__init__.py")
    code = ("import sys; sys.modules['triton'] = None\n"
            + "".join(f"import {m}\n" for m in mods)
            + "assert not any(m.split('.')[0] in ('jax', 'repro') "
              "for m in sys.modules), 'jax or repro loaded'\n")
    env = {"PATH": "/nonexistent", "PYTHONPATH": str(ROOT / "src"),
           "HOME": os.environ.get("HOME", "/tmp")}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_fastfold_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        FastFold(SMOKE)
    assert FastFold(SMOKE, device="cpu").device == torch.device("cpu")


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    """A CPU forward launches nothing: the counters stay at 0, and no
    kernel library is even looked up."""
    def no_kernel(name):
        raise AssertionError(f"kernel {name} reached from a CPU tensor")

    monkeypatch.setattr(_build, "entry", no_kernel)
    _build.reset_launches()
    ff = FastFold(SMOKE, device="cpu")
    batch = next(protein_batches(batch=1, n_seq=3, n_res=6, seed=0)).as_dict()
    out = ff.forward(ff.init(seed=0), batch, n_recycle=0)
    assert torch.isfinite(out["coords"]).all()
    x = torch.randn(4, 8)
    ops.layer_norm(x, torch.ones(8), torch.zeros(8))
    ops.bias_sigmoid_mul(x, torch.zeros(8), x)
    ops.fused_attention(torch.randn(2, 5, 1, 8), torch.randn(2, 5, 1, 8),
                        torch.randn(2, 5, 1, 8))
    assert sum(_build.LAUNCHES.values()) == 0


def test_kernel_wrappers_refuse_cpu_tensors():
    x = torch.randn(4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        layer_norm_cuda(x, torch.ones(8), torch.zeros(8))
    with pytest.raises(ValueError, match="CUDA"):
        bias_sigmoid_mul_cuda(x, torch.zeros(8), x)
    q = torch.randn(2, 5, 1, 8)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, q, q, None, None, 1.0)


def test_build_targets_sm90a_in_ignored_dir():
    cmd = _build.nvcc_command("nvcc", "layer_norm", Path("out.so"))
    assert "-gencode" in cmd
    assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    assert "-shared" in cmd and "-O3" in cmd
    assert _build.BUILD_DIR == ROOT / "build" / "kernels"
    assert _build.library_path("layer_norm").parent == _build.BUILD_DIR
    ignored = (ROOT / ".gitignore").read_text().split()
    assert "build/" in ignored
    sources = {p.stem for p in (PORT / "csrc").glob("*.cu")}
    assert sources == set(_build.SIGNATURES)


FAKE_NVCC = """\
import sys, time
out = sys.argv[sys.argv.index("-o") + 1]
start = time.monotonic()
time.sleep(0.5)
open(out + ".span", "w").write(f"{start} {time.monotonic()}")
open(out, "w").write(" ".join(sys.argv[1:]))
"""


def test_build_all_runs_one_nvcc_per_source_in_parallel(tmp_path, monkeypatch):
    """With a stand-in nvcc: every source gets its own process, all running
    at once, and each library appears under its final name only."""
    fake = tmp_path / "nvcc"
    fake.write_text(f"#!{sys.executable}\n" + FAKE_NVCC)
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(fake))
    libs = _build.build_all()
    assert set(libs) == set(_build.SIGNATURES)
    for name, path in libs.items():
        assert path.exists() and path.parent == tmp_path / "kernels"
        assert "arch=compute_90a,code=sm_90a" in path.read_text()
        assert path.read_text().endswith(f"csrc/{name}.cu")
    spans = [tuple(map(float, p.read_text().split()))
             for p in (tmp_path / "kernels").glob("*.span")]
    assert len(spans) == len(libs)
    assert not [p for p in (tmp_path / "kernels").glob("*.tmp*")
                if not p.name.endswith(".span")]
    # all builds were running at one moment: the last start precedes the
    # first end
    assert max(s for s, _ in spans) < min(e for _, e in spans), spans
    assert _build.build_all() == libs          # nothing rebuilt


def test_launch_check_raises_and_counts():
    _build.reset_launches()
    with pytest.raises(RuntimeError, match="cudaError_t 9"):
        _build.check("layer_norm", 9)
    assert _build.LAUNCHES["layer_norm"] == 0
    _build.check("layer_norm", 0)
    assert _build.LAUNCHES["layer_norm"] == 1
    _build.reset_launches()
    assert np.sum(list(_build.LAUNCHES.values())) == 0
