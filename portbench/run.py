"""Run one cell of the port's benchmark once and print its result line.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the port (``src/repro_torch``) and
a CUDA device; the cells are those of ``BENCHMARK.json``. The last line of
standard output is the result's JSON; the numbers ``correct`` compares are
the last lines of standard error.
"""
import time

T_PROCESS = time.time()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from portbench.harness.env import prepare  # noqa: E402

prepare(ROOT)
from portbench.harness.core import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_PROCESS))
