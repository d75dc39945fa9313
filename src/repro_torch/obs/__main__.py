"""``python -m repro_torch.obs report EVENTS.jsonl [--bench BENCH.json] [--strict]``

The port's copy of the reference's command.

Validates an event stream against the stable schema, renders the
aggregated report (span percentiles + self-time, request lifecycle
tallies, occupancy histograms, jit-entry churn, roofline-referenced
hardware-efficiency fractions), and checks the request-lifecycle
reconciliation invariant. With ``--bench`` it additionally schema-checks
a BENCH_serving.json payload. ``--strict`` turns any schema or
reconciliation problem into a nonzero exit.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.obs.events import read_jsonl, validate_events
from repro_torch.obs.report import reconcile, render_report, validate_bench


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m repro_torch.obs")
    sub = parser.add_subparsers(dest="cmd", required=True)
    rep = sub.add_parser("report", help="render a report over a JSONL "
                                        "event stream")
    rep.add_argument("events", help="JSONL file from Tracer.dump_jsonl")
    rep.add_argument("--bench", default=None,
                     help="also schema-validate this BENCH_serving.json")
    rep.add_argument("--strict", action="store_true",
                     help="exit nonzero on any schema/reconcile problem")
    args = parser.parse_args(argv)

    events = read_jsonl(args.events)
    problems = [f"schema: {p}" for p in validate_events(events)]
    print(render_report(events))
    problems += [f"reconcile: {p}" for p in reconcile(events)]

    if args.bench is not None:
        with open(args.bench, encoding="utf-8") as fh:
            payload = json.load(fh)
        bench_problems = validate_bench(payload)
        problems += [f"bench: {p}" for p in bench_problems]
        if not bench_problems:
            print(f"bench: {args.bench} valid "
                  f"({len(payload['rows'])} row(s))")

    for p in problems:
        print(f"PROBLEM {p}", file=sys.stderr)
    if problems:
        print(f"{len(problems)} problem(s)", file=sys.stderr)
        return 1 if args.strict else 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
