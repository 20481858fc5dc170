"""Image-quality metrics: PowerLogLogSlope and PercentMaximal.

Port of ``saguaro_tpu.kernels.qc`` (reference Illumination_QC_mult.py:31-125,
itself a transcription of centrosome's ``rps``):

1. quadrant-folded radii ``r2 = i^2 + j^2``, min-folded with flipud/fliplr;
2. low-frequency truncation to ``min(h, w) / 8``;
3. the normalisation ``img / median(|img - mean(img)|)`` when the image is
   not flat (the median of an even count is the mean of the two middle
   values, as ``jnp.median`` gives it);
4. FFT power of the mean-subtracted image;
5. ring sums for radii 2 .. floor(maxwidth) - 1;
6. the slope of the least-squares line of log(powersum) against
   log(radius) over rings with positive power, 0.0 with fewer than 3;
7. PercentMaximal = 100 * #pixels equal to the image max / #pixels.

Every step is batched over a (B, H, W) stack on the stack's device.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

__all__ = ["qc_metrics", "qc_metrics_batch"]


@lru_cache(maxsize=32)
def _radius_labels(shape: tuple[int, int]) -> tuple[np.ndarray, int]:
    """Quadrant-folded integer radius labels and the ring-count bound L.

    Rings 2..L-1 are analyzed; radii >= L are routed to a discard bin L.
    """
    h, w = shape
    radii2 = (np.arange(h).reshape(h, 1) ** 2) + (np.arange(w) ** 2)
    radii2 = np.minimum(radii2, np.flipud(radii2))
    radii2 = np.minimum(radii2, np.fliplr(radii2))
    radii = np.floor(np.sqrt(radii2)).astype(np.int32) + 1
    maxwidth = min(h, w) / 8.0
    L = int(np.floor(maxwidth))
    labels = np.where(radii < L, radii, L).astype(np.int32)
    return labels, L


def _median(x: torch.Tensor) -> torch.Tensor:
    """Row medians of (B, N), the two middle values averaged for even N."""
    n = x.shape[1]
    s = torch.sort(x, dim=1).values
    return s[:, (n - 1) // 2] * 0.5 + s[:, n // 2] * 0.5


def _rps_sums(imgs: torch.Tensor, labels: torch.Tensor, num_rings: int) -> torch.Tensor:
    """(B, H, W) images + (H * W,) int64 ring labels -> (B, num_rings - 2)
    power sums of rings 2 .. num_rings - 1."""
    b = imgs.shape[0]
    flat = imgs.float().reshape(b, -1)
    mean = flat.mean(dim=1, keepdim=True)
    ptp = flat.amax(dim=1) - flat.amin(dim=1)
    med = _median((flat - mean).abs())
    flat = torch.where(ptp[:, None] > 0, flat / med[:, None], flat)
    centred = (flat - flat.mean(dim=1, keepdim=True)).reshape(imgs.shape)
    mag = torch.fft.fft2(centred).abs()
    power = (mag * mag).reshape(b, -1)
    sums = torch.zeros((b, num_rings + 1), dtype=torch.float32, device=imgs.device)
    sums.index_add_(1, labels, power)
    return sums[:, 2:num_rings]


def _slope_from_powersum(radii_log: torch.Tensor, powersum: torch.Tensor) -> torch.Tensor:
    """Least-squares slope per row of (B, R) power sums against log radii."""
    valid = powersum > 0
    n = valid.sum(dim=1).float()
    x = torch.where(valid, radii_log, torch.zeros_like(powersum))
    y = torch.where(valid, torch.log(torch.where(valid, powersum, torch.ones_like(powersum))),
                    torch.zeros_like(powersum))
    sx, sy = x.sum(dim=1), y.sum(dim=1)
    sxx, sxy = (x * x).sum(dim=1), (x * y).sum(dim=1)
    denom = n * sxx - sx * sx
    slope = torch.where(denom != 0, (n * sxy - sx * sy) / denom, torch.zeros_like(denom))
    return torch.where(n > 2, slope, torch.zeros_like(slope))


def _percent_maximal(imgs: torch.Tensor) -> torch.Tensor:
    """(B, H, W) -> (B,) f32: 100 * #pixels at the image max / #pixels.
    The reference's XLA program folds ``100 * count / n`` into one
    multiplication, ``count * f32(100 * f32(1 / n))``; so does this, so
    that the two agree exactly."""
    flat = imgs.reshape(imgs.shape[0], -1).float()
    count = (flat == flat.amax(dim=1, keepdim=True)).sum(dim=1)
    scale = np.float32(100.0) * (np.float32(1.0) / np.float32(flat.shape[1]))
    return count.float() * float(scale)


def qc_metrics_batch(imgs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W) -> (PowerLogLogSlope (B,), PercentMaximal (B,)) f32."""
    imgs = torch.as_tensor(imgs)
    labels, L = _radius_labels(tuple(imgs.shape[1:]))
    pct = _percent_maximal(imgs)
    if L <= 2:
        return torch.zeros(imgs.shape[0], dtype=torch.float32, device=imgs.device), pct
    lab = torch.as_tensor(labels.reshape(-1), dtype=torch.int64, device=imgs.device)
    powersum = _rps_sums(imgs, lab, L)
    radii_log = torch.log(torch.arange(2, L, dtype=torch.float32, device=imgs.device))
    return _slope_from_powersum(radii_log, powersum), pct


def qc_metrics(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(PowerLogLogSlope, PercentMaximal) of one 2-D image, as 0-d tensors."""
    slopes, pcts = qc_metrics_batch(torch.as_tensor(img)[None])
    return slopes[0], pcts[0]
