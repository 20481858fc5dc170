"""Illumination (flat-field) correction and illumination-function estimation.

Port of ``saguaro_tpu.kernels.illum``. ``illum_correct`` is the pixelwise
division by a ``<ch>_illum.npy`` function. ``estimate_illumination`` is
CellProfiler's CorrectIlluminationCalculate "Regular" + Gaussian recipe:
the mean over the plate's images of a channel, a normalised separable
Gaussian of radius 3 sigma ("SAME" zero padding, divided by the blur of
ones so that the borders are not darkened), rescaled to unit mean and
floored. The convolutions run in full f32 (cuDNN's TF32 off), as the
reference's XLA convolutions do.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from saguaro_tpu_torch.device import full_f32, resolve_device

__all__ = ["illum_correct", "estimate_illumination"]


def _smooth_mean(mean_img: torch.Tensor, sigma: int) -> torch.Tensor:
    """Separable Gaussian blur of an (H, W) f32 image, divided by the blur
    of ones."""
    radius = 3 * sigma
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=mean_img.device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    k = k / torch.sum(k)
    ky, kx = k.view(1, 1, -1, 1), k.view(1, 1, 1, -1)

    def blur(t):
        t = F.conv2d(t[None, None], ky, padding=(radius, 0))
        return F.conv2d(t, kx, padding=(0, radius))[0, 0]

    with full_f32():
        return blur(mean_img) / blur(torch.ones_like(mean_img))


def estimate_illumination(images, sigma: int = 50, min_value: float = 1e-6,
                          device: str | torch.device | None = None) -> np.ndarray:
    """(N, H, W) channel stack -> (H, W) f32 illumination function.

    A tensor is processed on its own device; an array goes to ``device``
    (CUDA unless the caller names another)."""
    if isinstance(images, torch.Tensor):
        stack = images.float()
    else:
        stack = torch.as_tensor(np.asarray(images, np.float32), device=resolve_device(device))
    smooth = _smooth_mean(stack.mean(dim=0), sigma)
    smooth = smooth / torch.clamp(smooth.mean(), min=min_value)
    return torch.clamp(smooth, min=min_value).cpu().numpy()


def illum_correct(image: torch.Tensor, illum: torch.Tensor) -> torch.Tensor:
    """Pixelwise ``image / illum`` in float32 (shapes must match; callers keep
    the raw image when they do not)."""
    return image.float() / illum.float()
