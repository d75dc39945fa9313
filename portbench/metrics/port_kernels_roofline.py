"""The port's hand-written kernels against their roofline, in percent:
the summed least time of the work their sites must do over their summed
device time in the traced segment.

A kernel counts where the trace shows device time for it (its
``kernels/<K>.json`` symbols). Its sites are the reference model's sites
of the kind the file names, at the cell's shapes, once per site of each
traced item: a recompute or a chunk launches again but adds no work.
"""
from portbench.reference.costs import bound_s, site_work


def read(reading):
    t = reading.trace
    if t is None:
        return None
    spent = t.device_s_by(lambda o: o.port)
    bound = total = 0.0
    for spec in reading.cell.kernels:
        seconds = spent.get(spec["name"], 0.0)
        if seconds <= 0:
            continue
        total += seconds
        for rec in reading.traced:
            _, sites = reading.session.work_of(rec["kind"])
            bound += sum(n * bound_s(*site_work(spec["work"], dict(dims)))
                         for (work, dims), n in sites.items()
                         if work == spec["site"])
    if total <= 0:
        return None
    return 100.0 * bound / total
