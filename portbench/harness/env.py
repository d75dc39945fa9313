"""The process's environment for a run, set before torch is imported."""
import os
import sys
from pathlib import Path


def prepare(root: Path) -> None:
    """Import the port from the checkout (``root``, whose ``portbench`` the
    caller put on the path); one host thread for
    PyTorch's CPU ops (the port's steps are paced by the host, and idle
    OpenMP workers competing with the main thread made training steps
    10-15% slower and less steady on the card's 8 cores); the caches of
    anything that compiles inside the checkout."""
    sys.path.insert(1, str(root / "src"))
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["MKL_NUM_THREADS"] = "1"
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build"
                                             / "torch_extensions")
