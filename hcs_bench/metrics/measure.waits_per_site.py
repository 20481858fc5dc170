"""Host-blocking waits of measurement a site: the program's
``measure/<family>/wait`` records (``saguaro_tpu_torch.utils.timing``: a
convergence flag or a fetch to the host inside a measurement family) in
the traced stretch, over the sites measured there. The count repeats from
batch to batch of one traffic; finalize's one wait a batch is not a
``measure/`` record and is not counted. None where the program keeps no
such record."""


def read(run):
    tr = run.trace
    n = run.traced_calls.get("measure.dispatch", 0)
    if tr is None or not n:
        return None
    k = sum(1 for _, _, name in tr.ranges if name.startswith("measure/") and name.endswith("/wait"))
    return k / (n * run.traffic["sites_per_batch"]) if k else None
