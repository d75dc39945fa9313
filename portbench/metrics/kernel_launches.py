"""Device kernels launched per item in the traced segment: every kernel
the trace holds (copies and memsets left out), over the items traced."""


def read(reading):
    t = reading.trace
    if t is None or not t.items or not t.kernels():
        return None
    return len(t.kernels()) / t.items
