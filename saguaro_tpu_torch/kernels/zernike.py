"""Zernike shape moments — CP AreaShape_Zernike_n_m (n <= 9, 30 features;
port of ``saguaro_tpu/kernels/zernike.py``). The measurement computes them
in its pass C (``kernels/fused_measure``); ``zernike_features`` is the
reference's per-family form and its oracle: per pixel, the owning object's
centroid and largest centroid distance, every radial polynomial as a
combination of rho powers, and one per-label sum of the 60 real and
imaginary parts (K3 on CUDA).

Convention: moment = (n+1)/pi * sum_{pixels in the object, rho <= 1}
Z*_nm(rho, theta) / area, magnitude reported.
"""

from __future__ import annotations

import math
from functools import lru_cache
from math import factorial

import numpy as np
import torch

from saguaro_tpu_torch.device import full_f32

__all__ = ["ZERNIKE_INDEXES", "zernike_features"]

ZERNIKE_INDEXES: tuple[tuple[int, int], ...] = tuple(
    (n, m) for n in range(10) for m in range(n % 2, n + 1, 2)
)


@lru_cache(maxsize=1)
def _radial_coeffs() -> np.ndarray:
    """(len(ZERNIKE_INDEXES), 10) coefficients of rho^k for each R_nm."""
    coeffs = np.zeros((len(ZERNIKE_INDEXES), 10), np.float64)
    for i, (n, m) in enumerate(ZERNIKE_INDEXES):
        for s in range((n - m) // 2 + 1):
            c = (
                (-1) ** s
                * factorial(n - s)
                / (factorial(s) * factorial((n + m) // 2 - s) * factorial((n - m) // 2 - s))
            )
            coeffs[i, n - 2 * s] = c
    coeffs.setflags(write=False)
    return coeffs


def zernike_features(labels: torch.Tensor, max_cells: int = 1024) -> torch.Tensor:
    """(B, H, W) labels -> (B, max_cells, 30) Zernike magnitudes per object,
    in ``ZERNIKE_INDEXES`` order; ids >= max_cells fold into slot 0, empty
    labels give 0. Radii are normalized by each object's largest centroid
    distance."""
    # imported here: segment_cuda reads this module's index order
    from saguaro_tpu_torch.kernels import segment_cuda as sc
    from saguaro_tpu_torch.kernels.onehot_reduce import segment_matmul_sums
    from saguaro_tpu_torch.kernels.segment_reduce import _coords, _flat, _segment_reduce, _take

    b, h, w = labels.shape
    dev = labels.device
    seg = _flat(labels, max_cells)
    inside = (labels.reshape(b, -1) > 0).float()
    yf, xf = _coords(b, h, w, dev)
    s1 = segment_matmul_sums(seg, torch.stack([inside, yf * inside, xf * inside], dim=-1),
                             max_cells)
    area = s1[..., 0]
    denom = torch.clamp(area, min=1.0)
    dy = yf - _take(s1[..., 1] / denom, seg)
    dx = xf - _take(s1[..., 2] / denom, seg)
    dist = torch.sqrt(dy * dy + dx * dx)
    rmax = _segment_reduce(torch.where(inside > 0, dist, torch.full_like(dist, -1.0)), seg,
                        max_cells, "amax")
    rho = torch.clamp(dist / torch.clamp(_take(rmax, seg), min=1e-6), max=1.0)
    theta = torch.atan2(dy, dx)
    del dist, dy, dx

    coeffs = torch.tensor(_radial_coeffs(), dtype=torch.float32, device=dev)  # (30, 10)
    with full_f32():
        radials = torch.stack(sc.rho_powers(rho), dim=-1) @ coeffs.T  # (B, N, 30)
    ms = torch.tensor([m for _, m in ZERNIKE_INDEXES], dtype=torch.float32, device=dev)
    mtheta = theta[..., None] * ms
    radials = radials * inside[..., None]
    parts = torch.cat([radials * torch.cos(mtheta), radials * torch.sin(mtheta)], dim=-1)
    del radials, mtheta
    sums = segment_matmul_sums(seg, parts, max_cells)
    sre, sim = sums[..., :30], sums[..., 30:]
    mag = torch.sqrt(sre * sre + sim * sim)
    ns = torch.tensor([n for n, _ in ZERNIKE_INDEXES], dtype=torch.float32, device=dev)
    norm = (ns + 1.0) / math.pi / torch.clamp(area[..., None], min=1.0)
    return torch.where(area[..., None] > 0, mag * norm, torch.zeros_like(mag))
