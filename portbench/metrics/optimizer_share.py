"""The optimizer's share of a training step's host time, in percent: the
host time in the program's ``train.clip`` and ``train.optimizer`` spans,
less the step's wait for the device that ``train.optimizer`` holds
(``train.wait``), over the host time in its ``train.step`` spans, in a
segment run under the program's tracer. None where the program has no
such spans."""
from portbench.harness.spans import host


def read(reading):
    seg = host(reading)
    step = seg.seconds("train.step")
    if step <= 0:
        return None
    issue = (seg.seconds("train.clip") + seg.seconds("train.optimizer")
             - seg.seconds("train.wait"))
    return 100.0 * issue / step
