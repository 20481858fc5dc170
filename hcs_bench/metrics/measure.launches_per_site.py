"""Device activities launched inside the program's ``measure/<family>``
ranges in the traced stretch, a site measured there (the benchmark's own
pixel counts, in ``bench/roofline_count``, left out)."""


def read(run):
    tr = run.trace
    n = run.traced_calls.get("measure.dispatch", 0)
    if tr is None or not n:
        return None
    sites = n * run.traffic["sites_per_batch"]
    k = sum(1 for rng in tr.kernel_ranges
            if any(r.startswith("measure/") for r in rng) and "bench/roofline_count" not in rng)
    return k / sites if k else None
