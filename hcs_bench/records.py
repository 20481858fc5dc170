"""What a per-layer metric's reader gets: one run's record. A reader is a
file ``metrics/<metric name>.py`` with ``read(run: Run) -> float | None``;
it returns None where the run holds nothing for it to read, and the
harness then leaves the metric out of the result line."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Run:
    """``traffic``: the cell's traffic file; ``spans``: seconds of each
    benchmark-side span (synced in a traced run), summed over the stretch
    of ``span_s`` seconds after the profiler stopped, in which ``sites``
    sites were completed and ``span_crops`` crops embedded;
    ``trace``: the profiled stretch (``trace.Trace``), with ``traced_calls``
    the span calls inside it and ``traced_crops`` the crops embedded there;
    ``kernel_work``: (kernel, bytes, operations) of each call of the port's
    kernels inside it; ``model_flops``: the published models' FLOPs of one
    site (CPnet) and one crop (EfficientNetV2)."""

    traffic: dict
    sites: int
    spans: dict
    span_s: float = 0.0
    span_crops: int = 0
    trace: object = None
    traced_calls: dict = field(default_factory=dict)
    traced_crops: int = 0
    kernel_work: list = field(default_factory=list)
    model_flops: dict = field(default_factory=dict)
