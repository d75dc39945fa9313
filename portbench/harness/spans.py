"""Segments that read the program's own spans (``repro_torch.obs``).

A segment runs ``trace_items`` more items and the rest of their cycle,
through the session's ``item()``, and ends with ``drain()``, as the traced
segment does. Each kind runs at most once a run and is kept on the
``Reading``, so every metric family that reads it reads the same items:

- ``host(reading)``, under an obs tracer alone: the spans' host times.
- ``profiled(reading)``, under a tracer and ``torch.profiler`` (CPU and
  CUDA) inside the window's span: every obs span is then also a
  ``record_function`` range on the profiler's clock, beside the device
  operations its body launched, so the device's idle time can be put down
  to the host phase that was open when it passed.

A program without spans leaves both empty: ``profiled`` is then not run,
and the readers return None. Each segment prints one line or two to
standard error: the host seconds an item with the tracer on (in the
window's format), the host ms an item by span, and the device's idle ms an
item by the innermost span open.
"""
from __future__ import annotations

import bisect
import sys
import time
from collections import defaultdict
from dataclasses import dataclass

import torch

from portbench.harness.stats import gaps
from portbench.harness.trace import WINDOW_SPAN, summarize

HOST = "_spans_host"            # where each segment is kept on the Reading
PROFILED = "_spans_profiled"


@dataclass
class HostSegment:
    """The span events of a segment run under a tracer."""
    spans: list
    items: int

    def seconds(self, name: str) -> float:
        return sum(e["dur_ns"] for e in self.spans if e["name"] == name) / 1e9

    def count(self, name: str) -> int:
        return sum(1 for e in self.spans if e["name"] == name)

    def by_name(self) -> dict:
        out = defaultdict(float)
        for e in self.spans:
            out[e["name"]] += e["dur_ns"] / 1e9
        return dict(out)


@dataclass
class ProfiledSegment:
    """A profiled segment: its device operations and the spans' ranges
    (start, end, name) on the profiler's clock, in seconds."""
    trace: object                               # TraceSummary
    ranges: list

    def idle(self) -> list:
        """The device's idle stretches in the segment."""
        t = self.trace
        return gaps([(o.start, o.end) for o in t.ops], *t.window)

    def idle_within(self, names) -> float:
        """Idle seconds while a span of ``names`` was open on the host."""
        merged = []
        for s, e in sorted((s, e) for s, e, n in self.ranges if n in names):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        total, k, idle = 0.0, 0, self.idle()
        for s, e in merged:
            while k < len(idle) and idle[k][1] <= s:
                k += 1
            j = k
            while j < len(idle) and idle[j][0] < e:
                total += min(e, idle[j][1]) - max(s, idle[j][0])
                j += 1
        return total

    def idle_by_span(self) -> dict:
        """{span name: idle seconds while it was the innermost span open
        on the host}; None for the idle time outside every span. The
        ranges nest (one host thread), so each is its own idle less its
        children's."""
        idle = self.idle()
        starts = [s for s, _ in idle]
        cum = [0.0]
        for s, e in idle:
            cum.append(cum[-1] + e - s)

        def upto(t):                     # idle seconds before t
            k = bisect.bisect_right(starts, t)
            if k == 0:
                return 0.0
            s, e = idle[k - 1]
            return cum[k - 1] + min(t, e) - s

        out = defaultdict(float)
        stack = []                       # (end, name) of the open ranges
        for s, e, name in sorted(self.ranges, key=lambda r: (r[0], -r[1])):
            while stack and stack[-1][0] <= s:
                stack.pop()
            inside = upto(e) - upto(s)
            out[stack[-1][1] if stack else None] -= inside
            out[name] += inside
            stack.append((e, name))
        out[None] += sum(e - s for s, e in idle)
        return dict(out)


def _items(reading) -> tuple[int, list]:
    """Run the segment's items; (their number, host seconds each)."""
    session, n = reading.session, reading.cell.workload["trace_items"]
    mid_cycle = getattr(session, "mid_cycle", lambda: False)
    item_s = []
    while len(item_s) < n or mid_cycle():
        t0 = time.perf_counter()
        session.item()
        item_s.append(time.perf_counter() - t0)
    session.drain()
    return len(item_s), item_s


def _per_item(d: dict, items: int) -> str:
    return ", ".join(f"{'outside any span' if k is None else k} "
                     f"{1e3 * v / items:.1f}"
                     for k, v in sorted(d.items(), key=lambda kv: -kv[1]))


def host(reading) -> HostSegment:
    """The segment under a tracer alone (run at its first call)."""
    seg = getattr(reading, HOST, None)
    if seg is not None:
        return seg
    from repro_torch.obs import use_tracer

    with use_tracer() as tr:
        items, item_s = _items(reading)
    seg = HostSegment([e for e in tr.events if e["kind"] == "span"], items)
    setattr(reading, HOST, seg)
    s = sorted(item_s)
    print(f"spans: {items} items in {sum(item_s)!r} s with the tracer on; "
          f"host seconds an item min {s[0]!r} median {s[len(s) // 2]!r} "
          f"max {s[-1]!r}", file=sys.stderr)
    if seg.spans:
        print(f"spans: host ms an item by span: "
              f"{_per_item(seg.by_name(), items)}", file=sys.stderr)
    return seg


def profiled(reading) -> ProfiledSegment | None:
    """The segment under a tracer and the profiler (run at its first
    call); None where the host segment found no spans."""
    if not host(reading).spans:
        return None
    seg = getattr(reading, PROFILED, None)
    if seg is not None:
        return seg
    from repro_torch.obs import use_tracer

    act = torch.profiler.ProfilerActivity
    with use_tracer() as tr:
        with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
            with torch.profiler.record_function(WINDOW_SPAN):
                items, _ = _items(reading)
    names = {e["name"] for e in tr.events if e["kind"] == "span"}
    ranges = [(evt.start_ns() * 1e-9, evt.end_ns() * 1e-9, evt.name())
              for evt in prof.profiler.kineto_results.events()
              if evt.name() in names
              and evt.device_type() == torch.autograd.DeviceType.CPU]
    seg = ProfiledSegment(summarize(prof, reading.cell.kernels, items),
                          ranges)
    del prof
    setattr(reading, PROFILED, seg)
    idle = seg.idle_by_span()
    print(f"spans: profiled {items} items over {seg.trace.window_s!r} s, "
          f"device idle {sum(idle.values())!r} s; idle ms an item by "
          f"innermost span: {_per_item(idle, items)}", file=sys.stderr)
    return seg
