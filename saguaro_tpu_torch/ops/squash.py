"""Double-sigmoid squash of robustized z-scores (port of
``saguaro_tpu/ops/squash.py``).

Reference: ``(x/alpha)^k / sqrt(1 + (x/alpha)^(2k))`` with k=3,
alpha=2.3538 (Pycyto_pertime.py:13-16, Feature_select_cosine_ami.py:22-27),
applied feature-wise then ``abs()``'d. Soft-clips to (-1, 1).
"""

from __future__ import annotations

import torch

__all__ = ["double_sigmoid", "DEFAULT_K", "DEFAULT_ALPHA"]

DEFAULT_K = 3
DEFAULT_ALPHA = 2.3538


def double_sigmoid(x: torch.Tensor, k: int = DEFAULT_K, alpha: float = DEFAULT_ALPHA) -> torch.Tensor:
    """Elementwise on a tensor, in f32. ``alpha`` divides as a tensor on
    ``x``'s device: CUDA divides by a host scalar as a product with its
    reciprocal, which may round differently."""
    x = x.to(torch.float32)
    x = x / torch.tensor(alpha, dtype=torch.float32, device=x.device)
    xk = x**k
    return xk / torch.sqrt(1.0 + xk * xk)
