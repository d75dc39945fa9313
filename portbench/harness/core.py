"""One run of one cell: set-up, the measured window, the traced segment,
the check of ``correct``, the result line.

The window runs whole items (steps or requests) and starts none after
``--seconds``, unless the traffic's session says it is inside a cycle of
its mix (``mid_cycle``), which it then finishes; its end-to-end metrics
are taken over all of it. A ``--trace 1`` run then profiles a further
``trace_items`` items (the workload file's number), again ending on a
whole cycle, and reads its per-layer metrics from them, from the window
and from the reference's counts. The program's state is dropped before the
reference runs, after the peak memory is read.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import sys
import time
from dataclasses import dataclass, field

import torch

from portbench.harness import program
from portbench.harness.compare import verdict
from portbench.harness.spec import Cell, SpecError, load_cell
from portbench.harness.trace import WINDOW_SPAN, summarize

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Window:
    """What the measured window did: ``records`` one dict per item
    (``work``; a request also ``latency_s`` and ``done``), the host clock
    at its start and when its last item was done."""
    t_start: float
    t_done: float
    records: list = field(default_factory=list)
    item_s: list = field(default_factory=list)  # host seconds per item


@dataclass
class Reading:
    """What a per-layer metric's reader reads."""
    cell: Cell
    session: object
    window: Window
    trace: object                   # TraceSummary of the traced segment
    traced: list                    # records of the traced items


def forbidden_modules(names=None) -> list[str]:
    """The modules of ``names`` (by default every loaded one) whose
    top-level name is JAX's or the JAX package's."""
    names = list(sys.modules) if names is None else names
    return sorted({m for m in names if m.split(".", 1)[0] in FORBIDDEN})


def _now() -> float:
    return time.perf_counter()


def _per_layer(cell: Cell, reading: Reading) -> dict:
    out = {}
    for m in cell.per_layer:
        value = cell.metric_reader(m["name"]).read(reading)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def _traced(cell: Cell, session, mid_cycle) -> tuple:
    """(TraceSummary, records of the items): ``trace_items`` items and the
    rest of their cycle under the profiler."""
    traced = []
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        with torch.profiler.record_function(WINDOW_SPAN):
            while len(traced) < cell.workload["trace_items"] or mid_cycle():
                traced.append(session.item())
            session.drain()
    summary = summarize(prof, cell.kernels, len(traced))
    del prof
    return summary, traced


def run_cell(cell: Cell, seconds: float, trace: bool, t_process: float,
             control: str | None = None) -> tuple[dict, list, dict]:
    """(the result line's object, the compared rows, every number the
    check read). ``control``: put the reference at that precision in the
    program's place for the check."""
    session = cell.traffic_module().Session(cell)
    session.setup()
    program.synchronize(cell.device)
    on_card = torch.device(cell.device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    mid_cycle = getattr(session, "mid_cycle", lambda: False)
    t0 = _now()
    setup_s = time.time() - t_process
    window = Window(t0, t0)
    t = t0
    while t - t0 < seconds or mid_cycle():
        window.records.append(session.item())
        t, last = _now(), t
        window.item_s.append(t - last)
    session.drain()
    window.t_done = max([_now()] + [r["done"] for r in window.records
                                     if "done" in r])
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    metrics = session.end_to_end(window)
    metrics["setup_s"] = setup_s
    metrics["peak_hbm_gb"] = peak / 1e9
    result = {"correct": False, "attempted": len(window.records),
              "failed": session.failed(window)}
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": (torch.cuda.get_device_name() if on_card else "cpu"),
              "count": 1, "memory_peak_bytes": int(peak)}
    if window.item_s:
        item_s = sorted(window.item_s)
        print(f"window: {len(item_s)} items in {window.t_done - t0!r} s; "
              f"host seconds an item min {item_s[0]!r} median "
              f"{item_s[len(item_s) // 2]!r} max {item_s[-1]!r}",
              file=sys.stderr)
    if trace:
        summary, traced = _traced(cell, session, mid_cycle)
        span = window.t_done - t0
        print(f"trace: {len(summary.ops)} device operations, "
              f"{len(summary.kernels())} kernels, {summary.linked} with an "
              f"aten launcher; {summary.items} items over "
              f"{summary.window_s!r} s traced against {span!r} s for "
              f"{len(window.records)} in the window", file=sys.stderr)
        reading = Reading(cell, session, window, summary, traced)
        result["metrics"] = _per_layer(cell, reading)
        device["busy_s"] = summary.busy_s()
        device["window_s"] = summary.window_s
        result["breakdown"] = summary.breakdown()
    else:
        names = [m["name"] for m in cell.end_to_end]
        missing = [n for n in names if n not in metrics]
        if missing:
            raise SpecError(f"{cell.name}: traffic "
                            f"{cell.workload['traffic']!r} gives no "
                            f"{missing}")
        result["metrics"] = {m["name"]: {"value": metrics[m["name"]],
                                         "unit": m["unit"]}
                             for m in cell.end_to_end}
    result["device"] = device
    session.release()
    program.release(cell.device)
    # The reference is fp32: no TF32 in its products.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    numbers = session.check(control=control)
    ok, rows = verdict(numbers, cell.workload["limits"])
    result["correct"] = bool(ok and result["attempted"] > 0
                             and result["failed"] == 0)
    result["compared"] = {name: {"value": v, "limit": lim}
                          for name, v, lim in rows}
    return result, rows, numbers


def parse(argv):
    ap = argparse.ArgumentParser(prog="portbench/run.py",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True, help="the cell's name")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True,
                    help="how long the measured window lasts")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0,
                    help="1: report the per-layer metrics instead")
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be a non-negative whole number")
    return args


def cuda_driver_ready(tries: int = 10, wait_s: float = 2.0) -> bool:
    """Whether the CUDA driver initialises (``cuInit``), asked up to
    ``tries`` times: a card whose last process is still being torn down
    can refuse the first. torch caches the device count of its first
    look, so the driver is asked before torch is."""
    try:
        lib = ctypes.CDLL("libcuda.so.1")
    except OSError:
        return False
    for attempt in range(tries):
        if lib.cuInit(0) == 0:
            if attempt:
                print(f"portbench: cuInit succeeded at attempt {attempt + 1}",
                      file=sys.stderr)
            return True
        time.sleep(wait_s)
    return False


def main(argv, t_process: float) -> int:
    args = parse(argv)
    try:
        cell = load_cell(args.workload)
    except SpecError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    chips = cell.entry.get("chips", 1)
    cuda_driver_ready()
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {cell.name} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"device_count() = {torch.cuda.device_count()}. The benchmark "
              "measures the card and never falls back to the CPU.",
              file=sys.stderr)
        return 3
    cell.seed = args.seed
    cell.device = "cuda"
    result, rows, _ = run_cell(cell, args.seconds, bool(args.trace),
                               t_process)
    found = forbidden_modules()
    if found:
        print("portbench: modules of JAX or the JAX package were loaded: "
              + ", ".join(found), file=sys.stderr)
        return 4
    for name, value, limit in rows:
        flag = "ok" if math.isfinite(value) and value <= limit else "OVER"
        print(f"compared {name} = {value!r} limit {limit!r} {flag}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0
