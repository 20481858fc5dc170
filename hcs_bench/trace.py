"""Reading a torch.profiler trace of part of the window into what the
per-layer metrics and the breakdown need: the device's busy intervals, each
kernel's launching op and the host ranges (``measure/<family>`` from the
program, ``bench/<name>`` from the benchmark) around it, and the idle gaps
with what the host was doing."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

RANGE_PREFIXES = ("measure/", "bench/")
# CUPTI's records of its own overhead (a launch stalled on a full command
# buffer, a trace buffer requested): no operation of the program, neither on
# the device timeline nor as the op that launched a kernel
OVERHEAD = ("Command Buffer Full", "Activity Buffer Request", "Buffer Flush", "Instrumentation",
            "Lazy Function Loading", "Runtime Triggered Module Loading")


@dataclass
class Trace:
    """A traced stretch of the window. ``kernels``: one row a device
    activity, (start ns, end ns); ``kernel_names``; ``kernel_ranges``: the
    host ranges around each one's launch (innermost last); ``kernel_ops``:
    the name of the op that launched it; ``ranges``: every host range as
    (start ns, end ns, name)."""

    window_s: float
    kernels: np.ndarray
    kernel_names: list
    kernel_ops: list
    kernel_ranges: list
    ranges: list

    def busy_intervals(self) -> np.ndarray:
        """The union of the device activities' intervals, sorted, (k, 2) ns."""
        if len(self.kernels) == 0:
            return np.zeros((0, 2))
        iv = self.kernels[np.argsort(self.kernels[:, 0])]
        out = [list(iv[0])]
        for a, b in iv[1:]:
            if a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return np.array(out, dtype=np.float64)

    def busy_s(self) -> float:
        u = self.busy_intervals()
        return float((u[:, 1] - u[:, 0]).sum()) / 1e9

    def kernel_seconds(self) -> np.ndarray:
        return (self.kernels[:, 1] - self.kernels[:, 0]) / 1e9


def read(prof, window_s: float) -> Trace:
    """A finished ``torch.profiler.profile``'s raw events -> Trace."""
    from torch.autograd import DeviceType

    raw = list(prof.profiler.kineto_results.events())
    ranges, ops, dev = [], [], []
    for e in raw:
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            # device-side copies of host ranges, and CUPTI's own overhead
            if not name.startswith(RANGE_PREFIXES) and name not in OVERHEAD:
                dev.append((e.start_ns(), e.end_ns(), name, e.linked_correlation_id()))
        elif e.device_type() == DeviceType.CPU:
            if name.startswith(RANGE_PREFIXES):
                ranges.append((e.start_thread_id(), e.start_ns(), e.end_ns(), name))
            elif e.linked_correlation_id() == 0 and e.correlation_id() and name not in OVERHEAD:
                # ops: the CPU events no other links to (runtime calls link to
                # their op and carry a correlation id of another count)
                ops.append((e.start_thread_id(), e.start_ns(), e.correlation_id(), name))
    op_of = {corr: i for i, (_, _, corr, _) in enumerate(ops)}
    # the ranges of its thread around each op's start, innermost last
    r_thr = np.array([r[0] for r in ranges], dtype=np.int64)
    r_a = np.array([r[1] for r in ranges], dtype=np.int64)
    r_b = np.array([r[2] for r in ranges], dtype=np.int64)
    order = np.argsort(r_a, kind="stable")
    op_ranges: list = [None] * len(ops)
    kernel_ops, kernel_ranges = [], []
    for start, end, name, corr in dev:
        i = op_of.get(corr)
        if i is None:
            kernel_ops.append("")
            kernel_ranges.append(())
            continue
        if op_ranges[i] is None:
            thr, t0 = ops[i][0], ops[i][1]
            hit = order[(r_thr[order] == thr) & (r_a[order] <= t0) & (t0 < r_b[order])]
            op_ranges[i] = tuple(ranges[j][3] for j in hit)
        kernel_ops.append(ops[i][3])
        kernel_ranges.append(op_ranges[i])
    return Trace(
        window_s=window_s,
        kernels=np.array([(a, b) for a, b, _, _ in dev], dtype=np.float64).reshape(-1, 2),
        kernel_names=[n for _, _, n, _ in dev],
        kernel_ops=kernel_ops,
        kernel_ranges=kernel_ranges,
        ranges=[(a, b, n) for _, a, b, n in ranges],
    )


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time (the port's kernels by
    their ``sag/<counter>`` op, other kernels launched inside a
    ``measure/<family>`` range by that range, the rest by the op that
    launched them, or their own name where none did) and
    the idle gaps, summed by the innermost host range open at each gap's
    start (``host`` where none is)."""
    ops: dict[str, float] = {}
    for sec, name, op, rng in zip(tr.kernel_seconds(), tr.kernel_names, tr.kernel_ops,
                                  tr.kernel_ranges):
        fam = [r for r in rng if r.startswith("measure/")]
        key = op if op.startswith("sag/") else fam[-1] if fam else op or name[:80]
        ops[key] = ops.get(key, 0.0) + float(sec)
    gaps: dict[str, float] = {}
    u = tr.busy_intervals()
    if len(u) > 1:
        rs = sorted(tr.ranges)
        a = np.array([r[0] for r in rs], dtype=np.float64)
        b = np.array([r[1] for r in rs], dtype=np.float64)
        ends, lengths = u[:-1, 1], (u[1:, 0] - u[:-1, 1]) / 1e9
        for lo in range(0, len(ends), 65536):
            e = ends[lo : lo + 65536, None]
            inside = (a[None, :] <= e) & (e < b[None, :])
            # innermost: the open range that started last
            last = len(rs) - 1 - np.argmax(inside[:, ::-1], axis=1)
            for has, j, sec in zip(inside.any(axis=1), last, lengths[lo : lo + 65536]):
                key = rs[j][2] if has else "host"
                gaps[key] = gaps.get(key, 0.0) + float(sec)
    return {"device_ops": sorted(([k, v] for k, v in ops.items()), key=lambda x: -x[1])[:top],
            "idle_gaps": sorted(([k, v] for k, v in gaps.items()), key=lambda x: -x[1])[:top]}
