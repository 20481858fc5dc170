"""Z-stack maximum-intensity projection.

Port of ``saguaro_tpu.kernels.maxproj``: ``np.maximum.reduce`` over the
plane images of one channel group (MaxProjection.py:33-52), batched over
whole ``(batch, planes, H, W)`` blocks. PyTorch has no max reduction for
the unsigned 16- and 32-bit types, so those are widened to the next signed
type, reduced and narrowed back, which is exact.
"""

from __future__ import annotations

import torch

__all__ = ["max_project", "max_project_batch"]

_WIDER = {torch.uint16: torch.int32, torch.uint32: torch.int64}


def max_project_batch(stacks: torch.Tensor) -> torch.Tensor:
    """(batch, planes, H, W) -> (batch, H, W), exact in the input dtype."""
    wide = _WIDER.get(stacks.dtype)
    if wide is None:
        return stacks.amax(dim=1)
    return stacks.to(wide).amax(dim=1).to(stacks.dtype)


def max_project(stack: torch.Tensor) -> torch.Tensor:
    """(planes, H, W) -> (H, W) max-intensity projection."""
    return max_project_batch(stack[None])[0]
