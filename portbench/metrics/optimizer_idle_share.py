"""Share of a profiled training segment in which the device was idle
while the host was in the optimizer, in percent: the device's idle time
(no operation running) inside the program's ``train.clip`` and
``train.optimizer`` ranges, which its spans open on the profiler's clock,
over the segment's length. None where the program has no such spans."""
from portbench.harness.spans import profiled

NAMES = ("train.clip", "train.optimizer")


def read(reading):
    seg = profiled(reading)
    if seg is None or not any(n in NAMES for _, _, n in seg.ranges):
        return None
    if seg.trace.window_s <= 0:
        return None
    return 100.0 * seg.idle_within(NAMES) / seg.trace.window_s
