"""Readings that the limits of ``correct`` are set from: for each seed, a
run of the cell as ``run.py`` makes it, with the shortest window (one item
and the rest of its cycle), and every number its check reads: the
program's with ``--seeds``, the control's (the reference in fp8, with its
fp32 products in TF32, put in the program's place) with
``--control-seeds``; all in one process, on the card.

    python portbench/calibrate.py --workload <cell> --seeds 1 2 3 \
        [--control-seeds 4 5 6] [--out FILE]

Each reading is one JSON line on standard output (and in ``--out``).
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from portbench.harness.env import prepare  # noqa: E402

prepare(ROOT)
from portbench.harness import program  # noqa: E402
from portbench.harness.core import run_cell  # noqa: E402
from portbench.harness.spec import load_cell  # noqa: E402


def reading(cell, seed: int, control: str | None) -> dict:
    cell.seed = seed
    t0 = time.perf_counter()
    _, _, numbers = run_cell(cell, 1e-3, False, time.time(), control=control)
    program.release(cell.device)
    return {"cell": cell.name, "seed": seed,
            "side": control or "program", **numbers,
            "seconds": time.perf_counter() - t0}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out")
    args = ap.parse_args()
    cell = load_cell(args.workload)
    cell.device = "cuda"
    out = open(args.out, "a") if args.out else None
    try:
        for seed, control in ([(s, None) for s in args.seeds]
                              + [(s, "fp8") for s in args.control_seeds]):
            row = json.dumps(reading(cell, seed, control))
            print(row, flush=True)
            if out:
                out.write(row + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
