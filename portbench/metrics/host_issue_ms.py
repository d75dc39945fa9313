"""Host milliseconds an item spends issuing work, in a segment run under
the program's tracer: the mean host time of the item's root span (a
training step's ``train.step``, a request's ``fastfold.serve``) less the
time in it that the host waits for the device (``train.wait``). A fold
segment holds whole cycles of the mix. None where the program has no such
spans."""
from portbench.harness.spans import host

ROOTS = ("train.step", "fastfold.serve")
WAITS = ("train.wait",)


def read(reading):
    seg = host(reading)
    n = sum(seg.count(name) for name in ROOTS)
    if n == 0:
        return None
    issue = (sum(seg.seconds(name) for name in ROOTS)
             - sum(seg.seconds(name) for name in WAITS))
    return 1e3 * issue / n
