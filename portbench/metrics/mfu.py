"""Model FLOPs utilisation of the measured window, in percent: the
reference's matrix-product FLOPs of the items the window completed (every
pass's forward; for a step also the backward; no recompute) over the
window's seconds at the card's bf16 peak."""
from portbench.reference.costs import PEAK_FLOPS


def read(reading):
    w = reading.window
    span = w.t_done - w.t_start
    if not w.records or span <= 0:
        return None
    flops = sum(reading.session.work_of(r["kind"])[0] for r in w.records)
    return 100.0 * flops / (span * PEAK_FLOPS)
