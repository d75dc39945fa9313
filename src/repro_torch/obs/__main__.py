"""``python -m repro_torch.obs report EVENTS.jsonl [--strict]``

The port's copy of the reference's command.

Validates an event stream against the stable schema, renders the
aggregated report (span percentiles + self-time, request lifecycle
tallies, occupancy histograms, jit-entry churn, roofline-referenced
hardware-efficiency fractions), and checks the request-lifecycle
reconciliation invariant. ``--strict`` turns any schema or reconciliation
problem into a nonzero exit.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.obs.events import read_jsonl, validate_events
from repro_torch.obs.report import reconcile, render_report


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m repro_torch.obs")
    sub = parser.add_subparsers(dest="cmd", required=True)
    rep = sub.add_parser("report", help="render a report over a JSONL "
                                        "event stream")
    rep.add_argument("events", help="JSONL file from Tracer.dump_jsonl")
    rep.add_argument("--strict", action="store_true",
                     help="exit nonzero on any schema/reconcile problem")
    args = parser.parse_args(argv)

    events = read_jsonl(args.events)
    problems = [f"schema: {p}" for p in validate_events(events)]
    print(render_report(events))
    problems += [f"reconcile: {p}" for p in reconcile(events)]

    for p in problems:
        print(f"PROBLEM {p}", file=sys.stderr)
    if problems:
        print(f"{len(problems)} problem(s)", file=sys.stderr)
        return 1 if args.strict else 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
