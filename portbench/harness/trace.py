"""The profiled part of a window, reduced in memory: every device
operation with its interval and the host operation that launched it.

A kernel is grouped by the ``aten::`` operator that launched it: its
linked correlation id is that op's own id, or that of the runtime call
that launched it (a ``cudaLaunchKernel``), and then the innermost
``aten::`` op open at that moment is its launcher. The port's own kernels are launched through
``ctypes``, outside any operator, and are matched by name to the port
kernel files (``kernels/*.json``). A frozen copy of the grouping of the
port's ``scripts/torch_profile_serve.py``. No trace is written to disk.
"""
from __future__ import annotations

import bisect
import heapq
from collections import defaultdict
from dataclasses import dataclass, field

from portbench.harness.stats import gaps, union_length

GEMM_OPS = {"aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm",
            "aten::addbmm", "aten::_addmm_activation"}
COPY_OPS = {"aten::copy_", "aten::_to_copy", "aten::clone"}
WINDOW_SPAN = "portbench.traced_window"


def op_group(op: str | None) -> str:
    if op is None:
        return "launched outside any aten op"
    if op in GEMM_OPS:
        return "matrix products"
    if op in COPY_OPS:
        return "copies and casts"
    return "other aten ops"


@dataclass
class DeviceOp:
    name: str
    start: float            # seconds on the profiler's clock
    end: float
    kernel: bool            # a kernel (not a copy or a memset)
    launcher: str | None    # innermost aten op that launched it
    port: str | None        # the port kernel (K1..) its name belongs to

    @property
    def seconds(self) -> float:
        return self.end - self.start


@dataclass
class TraceSummary:
    ops: list = field(default_factory=list)     # DeviceOp
    window: tuple = (0.0, 0.0)                  # the traced span
    items: int = 0                              # items traced
    linked: int = 0                             # ops with an aten launcher

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_s(self) -> float:
        return union_length([(o.start, o.end) for o in self.ops],
                            *self.window)

    def kernels(self):
        return [o for o in self.ops if o.kernel]

    def device_s_by(self, key) -> dict:
        out = defaultdict(float)
        for o in self.kernels():
            out[key(o)] += o.seconds
        return dict(out)

    def group(self, o: DeviceOp) -> str:
        return f"{o.port} (port)" if o.port else op_group(o.launcher)

    def breakdown(self, n: int = 10) -> dict:
        """The device operations that took most time, by group and port
        kernel, and the longest idle time, by the operation the device then
        waited for."""
        by_group = self.device_s_by(self.group)
        ops = sorted(self.ops, key=lambda o: o.start)
        starts = [o.start for o in ops]
        idle = defaultdict(float)
        for s, e in gaps([(o.start, o.end) for o in ops], *self.window):
            k = bisect.bisect_left(starts, e)
            nxt = ops[k] if k < len(ops) else None
            name = ("after the last operation" if nxt is None
                    else f"before {self.group(nxt)}: "
                         f"{nxt.launcher or nxt.name[:60]}")
            idle[name] += e - s
        top = lambda d: [[k, v] for k, v in sorted(  # noqa: E731
            d.items(), key=lambda kv: -kv[1])[:n]]
        return {"device_ops": top(by_group), "idle_gaps": top(idle)}


def _port_of(name: str, kernels: list) -> str | None:
    for k in kernels:
        if any(sym in name for sym in k["symbols"]):
            return k["name"]
    return None


def _launchers(aten: list, launch: dict) -> dict:
    """{correlation id: the innermost aten op open when it was launched}.
    The op that contains the launch and started last; thread ids are not
    used, since the profiler's CPU ops and the runtime's calls number
    threads differently."""
    ops = sorted(aten)
    heap, k, out = [], 0, {}
    for t, cid in sorted((t, cid) for cid, t in launch.items()):
        while k < len(ops) and ops[k][0] <= t:
            heapq.heappush(heap, (-ops[k][0], ops[k][1], ops[k][2]))
            k += 1
        while heap and heap[0][1] < t:
            heapq.heappop(heap)
        out[cid] = heap[0][2] if heap else None
    return out


def summarize(prof, kernels: list, items: int) -> TraceSummary:
    """Reduce a finished ``torch.profiler.profile`` to a ``TraceSummary``;
    ``kernels`` the port kernel files, ``items`` the items traced."""
    from torch.autograd import DeviceType

    aten = []                       # (start, end, name)
    aten_ids = {}                   # an op's correlation id -> its name
    launch = {}                     # correlation id -> time of the launch
    window = None
    device = []
    for evt in prof.profiler.kineto_results.events():
        name = evt.name()
        if evt.device_type() == DeviceType.CUDA:
            # Annotations (a record_function's range on the device's
            # timeline) are not operations.
            if not evt.is_user_annotation() and name != WINDOW_SPAN:
                device.append(evt)
            continue
        t0, t1 = evt.start_ns() * 1e-9, evt.end_ns() * 1e-9
        if name.startswith("aten::"):
            aten.append((t0, t1, name))
            if evt.correlation_id():
                aten_ids[evt.correlation_id()] = name
        elif name == WINDOW_SPAN:
            window = (t0, t1)
        elif name.startswith("cu") and evt.correlation_id():
            # A runtime call (cudaLaunchKernel, cuLaunchKernel, ...).
            launch[evt.correlation_id()] = t0
    launcher = _launchers(aten, launch)
    launcher.update(aten_ids)
    summary = TraceSummary(items=items)
    for evt in device:
        name = evt.name()
        lower = name.lower()
        is_kernel = not (lower.startswith("memcpy") or lower.startswith(
            "memset"))
        summary.ops.append(DeviceOp(
            name=name, start=evt.start_ns() * 1e-9, end=evt.end_ns() * 1e-9,
            kernel=is_kernel,
            launcher=launcher.get(evt.linked_correlation_id()),
            port=_port_of(name, kernels) if is_kernel else None))
    if window is None:
        starts = [o.start for o in summary.ops] or [0.0]
        ends = [o.end for o in summary.ops] or [0.0]
        window = (min(starts), max(ends))
    summary.window = window
    summary.linked = sum(1 for evt in device
                         if launcher.get(evt.linked_correlation_id()))
    return summary
