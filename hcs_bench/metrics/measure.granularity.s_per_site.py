"""Device seconds a site of the granularity spectrum's
reconstructions: the device time of every
activity launched inside the program's ``measure/granularity`` range in the
profiled batch (PyTorch's kernels and the port's; the benchmark's own pixel
counts in ``bench/roofline_count`` left out), over the sites measured
there. Busy time of the device, read from the trace: the idle gaps inside
the range are not in it (``breakdown``'s ``idle_gaps`` has them). None
where no activity was launched in the range."""

FAMILY = "measure/granularity"


def read(run):
    tr = run.trace
    n = run.traced_calls.get("measure.dispatch", 0)
    if tr is None or not n:
        return None
    s = sum(float(sec) for sec, rng in zip(tr.kernel_seconds(), tr.kernel_ranges)
            if FAMILY in rng and "bench/roofline_count" not in rng)
    return s / (n * run.traffic["sites_per_batch"]) if s else None
