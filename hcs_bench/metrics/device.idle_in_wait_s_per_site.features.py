"""Idle seconds of the device a site, in the profiled batch, that open
while the host is blocked on measurement: the gaps between the device's
busy intervals (as ``trace.breakdown`` forms them) whose innermost open
host range at the gap's start is a ``measure/<family>/wait`` record of the
program (``saguaro_tpu_torch.utils.timing``), summed, over the sites
measured there. A gap that opens in the bare family range, while the host
is still launching, is not counted. None where the program keeps no such
record."""

import numpy as np


def _is_wait(name: str) -> bool:
    return name.startswith("measure/") and name.endswith("/wait")


def read(run):
    tr = run.trace
    n = run.traced_calls.get("measure.dispatch", 0)
    if tr is None or not n or not any(_is_wait(r[2]) for r in tr.ranges):
        return None
    sites = n * run.traffic["sites_per_batch"]
    u = tr.busy_intervals()
    if len(u) < 2:
        return 0.0
    rs = sorted(tr.ranges)
    a = np.array([r[0] for r in rs], dtype=np.float64)
    b = np.array([r[1] for r in rs], dtype=np.float64)
    wait = np.array([_is_wait(r[2]) for r in rs])
    ends, lengths = u[:-1, 1], (u[1:, 0] - u[:-1, 1]) / 1e9
    total = 0.0
    for lo in range(0, len(ends), 8192):
        e = ends[lo : lo + 8192, None]
        inside = (a[None, :] <= e) & (e < b[None, :])
        # innermost: the open range that started last
        last = len(rs) - 1 - np.argmax(inside[:, ::-1], axis=1)
        hit = inside.any(axis=1) & wait[last]
        total += float(lengths[lo : lo + 8192][hit].sum())
    return total / sites
