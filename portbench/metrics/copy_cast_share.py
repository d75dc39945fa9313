"""Share of the traced device kernel time that copies and casts take: the
kernels launched by ``aten::copy_``, ``aten::_to_copy`` or
``aten::clone``, over all kernels' time, in percent."""
from portbench.harness.trace import COPY_OPS


def read(reading):
    t = reading.trace
    if t is None:
        return None
    total = sum(o.seconds for o in t.kernels())
    if total <= 0:
        return None
    copies = sum(o.seconds for o in t.kernels() if o.launcher in COPY_OPS)
    return 100.0 * copies / total
