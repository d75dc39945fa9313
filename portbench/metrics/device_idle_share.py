"""Share of the measured window in which no operation ran on the device,
in percent: one less the device's busy time over the window's length. An
item's busy time is the union of the device operations' intervals in the
traced segment over its items (a whole number of cycles of the mix, as the
window is); the profiler lengthens the host's time an item but not the
kernels', so the share is the window's, not the traced segment's."""


def read(reading):
    t, w = reading.trace, reading.window
    span = w.t_done - w.t_start
    if t is None or not t.items or not t.ops or span <= 0:
        return None
    busy = t.busy_s() / t.items * len(w.records)
    return 100.0 * (1.0 - busy / span)
