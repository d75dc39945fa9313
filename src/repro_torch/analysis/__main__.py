"""`python -m repro_torch.analysis` — the port's analysis gate.

Runs repro-lint over the source tree, then the run-contract matrix over the
requested ExecutionPlan presets on a gloo group of ``--ranks`` processes,
prints a findings report, writes a JSON record only where ``--out`` names a
file, and exits nonzero on any finding or violation.

    PYTHONPATH=src python -m repro_torch.analysis --lint-only
    PYTHONPATH=src python -m repro_torch.analysis --contracts-only \\
        --device cpu --ranks 2 --presets default,oracle

Arguments are parsed and the lint runs before torch is imported:
``--lint-only`` works on a box with no backend at all.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="repro-lint (AST) + run contracts (collectives, gather "
                    "shapes, peak memory); nonzero exit on any "
                    "finding/violation.")
    ap.add_argument("--presets", default="default,oracle",
                    help="comma-separated ExecutionPlan presets for the "
                         "contract matrix (default: default,oracle)")
    ap.add_argument("--ranks", type=int, default=2,
                    help="gloo processes each cell runs on (default: 2)")
    ap.add_argument("--device", default=None, choices=("cpu", "cuda"),
                    help="where the ranks run (default: the card, which "
                         "they share)")
    ap.add_argument("--lint-only", action="store_true",
                    help="run only the AST pass (no torch import)")
    ap.add_argument("--contracts-only", action="store_true",
                    help="run only the contract matrix")
    ap.add_argument("--cells", default="",
                    help="comma-separated substrings filtering the contract "
                         "cells (default: all; e.g. 'evoformer_fwd,dap')")
    ap.add_argument("--out", default="",
                    help="write the contract matrix's records to this JSON "
                         "file (default: none)")
    ap.add_argument("--lint-root", default=None,
                    help="tree to lint (default: the installed "
                         "src/repro_torch)")
    args = ap.parse_args(argv)

    failed = False

    if not args.contracts_only:
        from repro_torch.analysis import lint

        findings = lint.lint_tree(args.lint_root)
        print(lint.render_report(findings), flush=True)
        failed |= bool(findings)

    if not args.lint_only:
        from repro_torch.analysis import cells
        from repro_torch.device import resolve_device

        device = resolve_device(args.device).type
        presets = [p for p in args.presets.split(",") if p]
        selected = cells.CELLS
        if args.cells:
            pats = [c for c in args.cells.split(",") if c]
            selected = tuple(c for c in cells.CELLS
                             if any(p in c.__name__ for p in pats))
            if not selected:
                print(f"no contract cell matches {pats!r}")
                return 1
        violations, rows = cells.run_matrix(presets, cells=selected,
                                            ranks=args.ranks, device=device)
        for row in rows:
            status = "FAIL" if row["violations"] else "ok"
            ratio = row["ratio"] if row["ratio"] is not None else "-"
            print(f"contract {row['cell']}: {status} "
                  f"(peak ratio {ratio}, "
                  f"collectives {sum(row['collectives'].values()):g})")
        for v in violations:
            print(f"  VIOLATION {v.render()}")
        print(f"contracts: {len(rows)} artifact(s), "
              f"{len(violations)} violation(s)")
        if args.out:
            payload = {"presets": presets, "ranks": args.ranks,
                       "device": device, "cells": rows}
            with open(args.out, "w", encoding="utf-8") as fh:
                json.dump(payload, fh, indent=1, sort_keys=True)
                fh.write("\n")
            print(f"wrote {os.path.abspath(args.out)}")
        failed |= bool(violations)

    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
