"""Per-stage timing and trace ranges (port of ``saguaro_tpu/utils/timing.py``).

A pipeline wraps its stages in a ``StageTimer`` (wall-clock seconds per named
stage, logged as a summary table); ``trace_annotation`` is a
``torch.profiler.record_function`` range, so a profiler trace carries the
pipeline's stage names (``segment``, ``embed``) as it carries the
measurement's ``measure/<family>`` ranges. Without a running profiler a
range costs one small host call.
"""

from __future__ import annotations

import contextlib
import logging
import time
from collections import defaultdict

import torch

logger = logging.getLogger("saguaro_tpu_torch.timing")

__all__ = ["StageTimer", "trace_annotation"]


def trace_annotation(name: str):
    """Named range in torch.profiler traces."""
    return torch.profiler.record_function(name)


class StageTimer:
    """Accumulates wall-clock per named stage; prints a summary table. A
    stage's time is the host's: it includes the device's only where the
    stage ends by waiting on it."""

    def __init__(self):
        self.total: dict[str, float] = defaultdict(float)
        self.count: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        with trace_annotation(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.total[name] += time.perf_counter() - t0
                self.count[name] += 1

    def summary(self) -> str:
        lines = ["stage timings:"]
        for name in sorted(self.total, key=lambda n: -self.total[n]):
            t, c = self.total[name], self.count[name]
            lines.append(f"  {name:<30s} {t:8.2f}s total  {t / max(c, 1):8.3f}s/call  x{c}")
        return "\n".join(lines)

    def log_summary(self) -> None:
        logger.info("%s", self.summary())
