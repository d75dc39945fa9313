import os
import sys

# NOTE: no --xla_force_host_platform_device_count here — smoke tests and
# benches must see 1 device. Multi-device tests spawn subprocesses that set
# the flag before importing jax (see test_distributed.py).
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax  # noqa: E402

jax.config.update("jax_default_matmul_precision", "highest")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips where there is none")
