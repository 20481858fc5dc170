"""Per-stage timing, and the program's recorder of spans, waits and counters
(port of ``saguaro_tpu/utils/timing.py``, grown).

``StageTimer`` accumulates the host seconds of named stages and logs them
as a summary table, as the reference's does. It is also the one recorder
of the program: ``with timer.recording(device):`` makes it the active
recorder, and until the block ends the module-level helpers below report
to it. Without an active recorder they keep nothing.

- ``span(name)``: a layer or family boundary. Always a
  ``torch._C._profiler._RecordFunctionFast`` record, an op in a
  torch.profiler trace, on the profiler's clock beside the device's
  activities (and a no-op without a profiler). With a recorder active it
  is also a row: its name, its host enter and exit on
  ``time.perf_counter_ns``, its parent span and, on the recorder's CUDA
  device, a timing event recorded at enter and one at exit on the current
  stream. ``trace_annotation``, the reference's name, is ``span``.
- ``flag(t, loop)``, ``fetch(t, loop)`` and ``blocking(loop)``: the points
  where the host blocks on the device (a convergence flag, a copy to the
  host, an event's synchronize), each the blocking call itself. Each is a
  profiler record ``<innermost open span>/wait`` (``measure/<family>/wait``
  inside a measurement family); with a recorder active it is counted under
  ``waits/<loop>`` with its blocked host seconds, and kept as a row.
- ``count(name, n)``: an integer counter (``rounds/<loop>``: the sweeps or
  rounds a fixpoint loop ran). Given a dict of launch counts
  (``recording(launches=segment_cuda.LAUNCHES)``), the recorder also counts
  the launches of the port's kernels between its open and its close, as
  ``launches/<kernel>``.

One clock: when the recorder opens it synchronises the device and records
an anchor event, and reads the host clock beside it; when it closes it
synchronises again and places every span's events at the anchor's host
time plus their elapsed time from the anchor. Every span thus has two
intervals on ``perf_counter_ns``: its host enter and exit, and the moments
the device reached its enter and exit markers. ``span_table`` and
``summary`` give per name the calls, host seconds, device seconds and self
time (the span minus its children).
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from collections import defaultdict
from dataclasses import dataclass

import torch

logger = logging.getLogger("saguaro_tpu_torch.timing")

__all__ = [
    "StageTimer",
    "blocking",
    "count",
    "fetch",
    "flag",
    "is_recording",
    "span",
    "stage",
    "trace_annotation",
]

_RECORD = torch._C._profiler._RecordFunctionFast
_active: StageTimer | None = None
# each thread's open spans, innermost last: (name, row index or None)
_local = threading.local()


def _open_spans() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


@dataclass(slots=True)
class SpanRow:
    """One span or wait the active recorder kept. ``t0``/``t1``: host enter
    and exit (ns, ``perf_counter_ns``); ``d0``/``d1``: the moments the
    device reached its enter and exit markers on the same clock (None
    without device markers); ``parent``: the row index of the span it
    opened in; ``kind``: ``span`` or ``wait``."""

    name: str
    parent: int | None
    t0: int
    t1: int = 0
    d0: float | None = None
    d1: float | None = None
    kind: str = "span"


class span:
    """A span named ``name``: a profiler record, and a row of the active
    recorder (see the module docstring)."""

    __slots__ = ("name", "_prof", "_rec", "_row", "_ev0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        rec = _active
        self._prof = _RECORD(self.name)
        self._prof.__enter__()
        stack = _open_spans()
        self._rec = rec
        if rec is None:
            self._row = None
        else:
            self._row, self._ev0 = rec._enter(self.name, stack)
        stack.append((self.name, self._row))
        return self

    def __exit__(self, *exc):
        _open_spans().pop()
        if self._rec is not None:
            self._rec._exit(self._row, self._ev0)
        self._prof.__exit__(*exc)
        return False


class blocking:
    """Wraps a call that blocks the host on the device: a profiler record
    ``<innermost open span>/wait``, counted under ``waits/<loop>`` with its
    host seconds by the active recorder."""

    __slots__ = ("loop", "_prof", "_rec", "_t0", "_name", "_parent")

    def __init__(self, loop: str):
        self.loop = loop

    def __enter__(self):
        stack = _open_spans()
        self._name = f"{stack[-1][0]}/wait" if stack else "wait"
        self._prof = _RECORD(self._name)
        self._prof.__enter__()
        self._rec = _active
        if self._rec is not None:
            self._parent = stack[-1][1] if stack else None
            self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self._rec is not None:
            self._rec._wait(self.loop, self._name, self._parent, self._t0, time.perf_counter_ns())
        self._prof.__exit__(*exc)
        return False


# the reference's name for a named range
trace_annotation = span


def flag(t: torch.Tensor, loop: str) -> bool:
    """``bool(t.any())`` (``bool(t)`` of a 0-d tensor), the read back a
    wait; the reduction is launched before the wait begins."""
    if t.dim():
        t = t.any()
    with blocking(loop):
        return bool(t)


def fetch(t: torch.Tensor, loop: str):
    """``t.cpu().numpy()``, a wait."""
    with blocking(loop):
        return t.cpu().numpy()


def is_recording() -> bool:
    """Whether a recorder is active: a caller that would read the device
    only to count for it reads nothing without one."""
    return _active is not None


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the active recorder's counter ``name``."""
    rec = _active
    if rec is not None:
        rec.counters[name] += n


def stage(name: str):
    """A stage of the active recorder (``StageTimer.stage``), or a bare
    span without one."""
    rec = _active
    return rec.stage(name) if rec is not None else span(name)


class StageTimer:
    """Accumulates wall-clock per named stage; prints a summary table. A
    stage's time is the host's: it includes the device's only where the
    stage ends by waiting on it. A stage is a span too. While
    ``recording``, the timer keeps the spans, waits and counters of the
    module's helpers."""

    def __init__(self):
        self.total: dict[str, float] = defaultdict(float)
        self.count: dict[str, int] = defaultdict(int)
        self.counters: dict[str, int] = defaultdict(int)
        self.wait_s: dict[str, float] = defaultdict(float)
        self.rows: list[SpanRow] = []
        self._events: list = []
        self._device: torch.device | None = None
        self._anchor = None
        self._anchor_ns = 0

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            with span(name):
                yield
        finally:
            self.total[name] += time.perf_counter() - t0
            self.count[name] += 1

    # ---------------- the recorder ----------------

    @contextlib.contextmanager
    def recording(self, device=None, launches: dict | None = None):
        """Makes this timer the active recorder for the block. With a CUDA
        ``device`` its spans also take device markers on that device: the
        device is synchronised at open (then the anchor event) and at
        close, where the events are resolved onto the host clock. With
        ``launches``, a dict of launch counts by kernel that the block's
        work adds to (the port's ``segment_cuda.LAUNCHES``), its increase
        over the block is counted as ``launches/<kernel>``."""
        global _active
        if _active is not None:
            raise RuntimeError("a recorder is already active")
        dev = torch.device(device) if device is not None else None
        if dev is not None and dev.type == "cuda":
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            torch.cuda.synchronize(dev)
            with torch.cuda.device(dev):
                self._anchor = torch.cuda.Event(enable_timing=True)
                self._anchor_ns = time.perf_counter_ns()
                self._anchor.record()
            self._device = dev
        before = dict(launches or {})
        _active = self
        try:
            yield self
        finally:
            _active = None
            self._close(launches or {}, before)

    def _close(self, launches: dict, before: dict) -> None:
        if self._device is not None:
            torch.cuda.synchronize(self._device)
            for i, ev0, ev1 in self._events:
                row = self.rows[i]
                row.d0 = self._anchor_ns + self._anchor.elapsed_time(ev0) * 1e6
                row.d1 = self._anchor_ns + self._anchor.elapsed_time(ev1) * 1e6
        self._events, self._device, self._anchor = [], None, None
        for k, v in launches.items():
            if v != before.get(k, 0):
                self.counters[f"launches/{k}"] += v - before.get(k, 0)

    def _marker(self):
        dev = self._device
        if dev is None or torch.cuda.current_device() != dev.index:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _enter(self, name: str, stack: list):
        parent = stack[-1][1] if stack else None
        self.rows.append(SpanRow(name, parent, time.perf_counter_ns()))
        return len(self.rows) - 1, self._marker()

    def _exit(self, i: int, ev0) -> None:
        if ev0 is not None:
            ev1 = self._marker()
            if ev1 is not None:
                self._events.append((i, ev0, ev1))
        self.rows[i].t1 = time.perf_counter_ns()

    def _wait(self, loop: str, name: str, parent: int | None, t0: int, t1: int) -> None:
        self.rows.append(SpanRow(name, parent, t0, t1, kind="wait"))
        self.counters[f"waits/{loop}"] += 1
        self.wait_s[f"waits/{loop}"] += (t1 - t0) / 1e9

    def span_table(self) -> dict[str, dict]:
        """Per name of the kept spans and waits: ``calls``, ``host_s``,
        ``device_s`` (between the device markers; 0 without them) and
        ``self_s`` (host seconds less its children's)."""
        child = [0] * len(self.rows)
        for r in self.rows:
            if r.parent is not None:
                child[r.parent] += r.t1 - r.t0
        out: dict[str, dict] = {}
        for i, r in enumerate(self.rows):
            e = out.setdefault(r.name, {"calls": 0, "host_s": 0.0, "device_s": 0.0, "self_s": 0.0})
            e["calls"] += 1
            e["host_s"] += (r.t1 - r.t0) / 1e9
            e["self_s"] += (r.t1 - r.t0 - child[i]) / 1e9
            if r.d0 is not None:
                e["device_s"] += (r.d1 - r.d0) / 1e9
        return out

    def summary(self) -> str:
        lines = ["stage timings:"]
        for name in sorted(self.total, key=lambda n: -self.total[n]):
            t, c = self.total[name], self.count[name]
            lines.append(f"  {name:<30s} {t:8.2f}s total  {t / max(c, 1):8.3f}s/call  x{c}")
        table = self.span_table()
        if table:
            lines.append("spans (host s, device s, host self s):")
            for name, e in sorted(table.items(), key=lambda kv: -kv[1]["host_s"]):
                lines.append(f"  {name:<36s} x{e['calls']:<6d} {e['host_s']:9.4f}  "
                             f"{e['device_s']:9.4f}  {e['self_s']:9.4f}")
        if self.counters:
            lines.append("counters:")
            for name in sorted(self.counters):
                extra = f"  {self.wait_s[name]:9.4f}s" if name in self.wait_s else ""
                lines.append(f"  {name:<36s} {self.counters[name]:10d}{extra}")
        return "\n".join(lines)

    def log_summary(self) -> None:
        logger.info("%s", self.summary())
