"""Host-side utilities: stage timing, trace ranges and the program's recorder
of spans, waits and counters (``timing``)."""

from saguaro_tpu_torch.utils.timing import StageTimer, trace_annotation

__all__ = ["StageTimer", "trace_annotation"]
