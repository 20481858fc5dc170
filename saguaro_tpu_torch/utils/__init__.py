"""Host-side utilities: stage timing and trace ranges."""

from saguaro_tpu_torch.utils.timing import StageTimer, trace_annotation

__all__ = ["StageTimer", "trace_annotation"]
