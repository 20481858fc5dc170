"""Host seconds a site that measurement blocks on the device: the lengths
of the program's ``measure/<family>/wait`` records
(``saguaro_tpu_torch.utils.timing``: a convergence flag or a fetch to the
host inside a measurement family) in the profiled batch, summed, over the
sites measured there. finalize's one wait a batch is not a ``measure/``
record and is not in it. None where the program keeps no such record."""


def read(run):
    tr = run.trace
    n = run.traced_calls.get("measure.dispatch", 0)
    if tr is None or not n:
        return None
    ns = [b - a for a, b, name in tr.ranges if name.startswith("measure/") and name.endswith("/wait")]
    return sum(ns) / 1e9 / (n * run.traffic["sites_per_batch"]) if ns else None
