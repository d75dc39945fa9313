"""Build and load the hand-written CUDA kernels (``src/repro_torch/csrc``).

Each ``csrc/*.cu`` file has a plain C interface and is compiled on its own by
``nvcc`` for ``sm_90a`` into a shared library under ``build/kernels/`` at the
root of the checkout (a directory git ignores), then loaded with ``ctypes``.
All sources build in parallel, at first use, never at import. A library's
file name carries a hash of its source and flags, so an unchanged kernel is
not rebuilt within one checkout.

The launch counters live here too: each kernel wrapper adds one to its
entry right after its kernel launched, and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from collections import Counter
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-shared", "-Xcompiler",
                           "-fPIC", "-lineinfo"]

LAUNCHES: Counter = Counter()

_c_void_p = ctypes.c_void_p
_c_int = ctypes.c_int
_c_ll = ctypes.c_longlong
_c_float = ctypes.c_float

# C signature of each kernel's entry point (all return a cudaError_t as int).
SIGNATURES = {
    "layer_norm": ("layer_norm_fwd", [
        _c_void_p, _c_void_p, _c_void_p, _c_void_p,   # x, gamma, beta, out
        _c_ll, _c_int, _c_float, _c_int, _c_void_p]),  # rows, C, eps, dtype, stream
    "bias_sigmoid_mul": ("bias_sigmoid_mul_fwd", [
        _c_void_p, _c_void_p, _c_void_p, _c_void_p,   # g, bg, v, out
        _c_ll, _c_int, _c_int, _c_void_p]),            # numel, C, dtype, stream
    "flash_attention_fwd": ("flash_attention_fwd", [
        _c_void_p, _c_void_p, _c_void_p,              # q, k, v
        _c_void_p, _c_void_p,                         # bias, mask (or NULL)
        _c_void_p, _c_void_p,                         # out, lse
        _c_ll, _c_ll, _c_ll, _c_ll, _c_ll, _c_ll,     # q/k/v strides (n, s)
        _c_int, _c_int, _c_int, _c_int, _c_int,       # N, Sq, Skv, H, D
        _c_int, _c_float, _c_int, _c_void_p]),        # rep, scale, dtype, stream
}

# The kernels' dtype argument.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_entries: dict = {}   # name -> typed ctypes function; keeps its library loaded


def reset_launches() -> None:
    LAUNCHES.clear()


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([Path(home) / "bin" / "nvcc"] if home else []) + [
            Path("/usr/local/cuda/bin/nvcc")]:
        if cand.is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH): the CUDA kernels of repro_torch are built at first use")
    return found


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def nvcc_command(nvcc: str, name: str, out: Path) -> list[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build_all() -> dict[str, Path]:
    """Compile every kernel whose library is missing, one ``nvcc`` per
    source, all started together. Returns each kernel's library path."""
    todo = [n for n in SIGNATURES if not library_path(n).exists()]
    if todo:
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # Each library is written under a temporary name and renamed when
        # complete, so a build that was cut off never leaves a library.
        tmp = {n: library_path(n).with_suffix(f".tmp{os.getpid()}")
               for n in todo}
        procs = {n: subprocess.Popen(nvcc_command(nvcc, n, tmp[n]),
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
                 for n in todo}
        errors = []
        for n, proc in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"--- nvcc {n}.cu (exit {proc.returncode}) ---\n"
                              f"{out}")
            else:
                os.replace(tmp[n], library_path(n))
        if errors:
            raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return {n: library_path(n) for n in SIGNATURES}


def entry(name: str):
    """The kernel's typed C entry point; its library is built at first use."""
    fn = _entries.get(name)
    if fn is None:
        with _lock:
            if name not in _entries:
                lib = ctypes.CDLL(str(build_all()[name]))
                fn_name, argtypes = SIGNATURES[name]
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _entries[name] = fn
            fn = _entries[name]
    return fn


def check(name: str, err: int) -> None:
    """Raise on a launch the CUDA runtime refused; count it otherwise."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError_t {err}")
    LAUNCHES[name] += 1
