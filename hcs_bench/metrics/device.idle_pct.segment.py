"""Share of a site's time in which no activity ran on the device: one
minus the device's busy seconds a site in the profiled batch (the union of
the trace's device intervals) over the seconds a site took in the stretch
after the profiler stopped, which the profiler's cost per launch does not
slow."""


def read(run):
    tr = run.trace
    traced = run.traced_calls.get("segment", 0) * run.traffic["sites_per_batch"]
    if tr is None or not traced or not run.sites or run.span_s <= 0 or len(tr.kernels) == 0:
        return None
    return 100.0 * (1.0 - (tr.busy_s() / traced) / (run.span_s / run.sites))
