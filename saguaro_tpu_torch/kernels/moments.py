"""Per-object image moments, the CP 4.2.8 AreaShape moment families (port
of ``saguaro_tpu/kernels/moments.py``).

CellProfiler's MeasureObjectSizeShape emits skimage regionprops' moment set
per object: SpatialMoment_p_q (raw moments in bounding-box coordinates, p, q
in 0..3), CentralMoment_p_q, NormalizedMoment_p_q, HuMoment_0..6,
InertiaTensor_i_j, InertiaTensorEigenvalues_0/1 and EquivalentDiameter.

Pass 1 sums each object's area and coordinates and takes its bounding-box
corner (a segment min); pass 2 gathers those per pixel and sums the locally
centred power products (y - cy)^p (x - cx)^q and (y - ymin)^p (x - xmin)^q,
32 lanes, in one ``segment_matmul_sums`` (K3 on CUDA). Centring before the
powers keeps the sums at object scale: global moments shifted binomially
lose f32 precision at sixth powers of image coordinates.

``fused_object_features`` computes the same families inside its lane
scans; this module is its oracle, as in the reference.

Labels carry a leading site-batch dimension: (B, H, W); every output is
(B, max_cells).
"""

from __future__ import annotations

import math

import torch

from saguaro_tpu_torch.kernels.fused_measure import _segment_reduce
from saguaro_tpu_torch.kernels.onehot_reduce import segment_matmul_sums

__all__ = ["moments_features"]

_ORDERS = [(p, q) for p in range(4) for q in range(4)]


def _gather(table: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """(B, max_cells) per-object values -> (B, N) per-pixel values."""
    return torch.gather(table, 1, seg.long())


def moments_features(labels: torch.Tensor, max_cells: int = 1024) -> dict[str, torch.Tensor]:
    """Every CP moment-family AreaShape column of every object: labels
    (B, H, W) -> {column: (B, max_cells)}; labels outside (0, max_cells)
    fold into the ignored slot 0."""
    b, h, w = labels.shape
    dev = labels.device
    flat = labels.reshape(b, h * w).to(torch.int32)
    seg = torch.where((flat > 0) & (flat < max_cells), flat, torch.zeros_like(flat))
    inside_m = flat > 0
    inside = inside_m.float()
    y = torch.arange(h, dtype=torch.float32, device=dev).repeat_interleave(w).expand(b, -1)
    x = torch.arange(w, dtype=torch.float32, device=dev).repeat(h).expand(b, -1)

    # pass 1: area, centroid, bounding-box corner
    s1 = segment_matmul_sums(seg, torch.stack([inside, y * inside, x * inside], dim=-1), max_cells)
    area = s1[..., 0]
    zero = area <= 0
    denom = torch.clamp(area, min=1.0)
    cy, cx = s1[..., 1] / denom, s1[..., 2] / denom
    big = torch.full_like(y, 1e9)
    corner = _segment_reduce(torch.stack([torch.where(inside_m, y, big),
                                          torch.where(inside_m, x, big)], dim=-1),
                             seg, max_cells, "amin")
    ymin = torch.where(zero, 0.0, corner[..., 0])
    xmin = torch.where(zero, 0.0, corner[..., 1])

    # pass 2: object-local coordinates per pixel, then the power sums
    yc = (y - _gather(cy, seg)) * inside
    xc = (x - _gather(cx, seg)) * inside
    yb = (y - _gather(ymin, seg)) * inside
    xb = (x - _gather(xmin, seg)) * inside

    def power_products(yloc, xloc):
        ypow = [inside, yloc, yloc * yloc, yloc * yloc * yloc]
        xpow = [inside, xloc, xloc * xloc, xloc * xloc * xloc]
        return [ypow[p] * xpow[q] for p, q in _ORDERS]

    payload = torch.stack(power_products(yb, xb) + power_products(yc, xc), dim=-1)  # (B, N, 32)
    del yc, xc, yb, xb
    sums = segment_matmul_sums(seg, payload, max_cells)
    del payload

    out: dict[str, torch.Tensor] = {}

    def z(a):
        return torch.where(zero, torch.zeros_like(a), a)

    # spatial moments: bounding-box coordinates (regionprops crops the
    # object to its box first)
    for i, (p, q) in enumerate(_ORDERS):
        out[f"SpatialMoment_{p}_{q}"] = z(sums[..., i])
    mu = {pq: sums[..., len(_ORDERS) + i] for i, pq in enumerate(_ORDERS)}
    for p, q in _ORDERS:
        out[f"CentralMoment_{p}_{q}"] = z(mu[(p, q)])
    # normalized moments nu_pq = mu_pq / mu00^(1 + (p+q)/2)
    nu = {}
    for p, q in _ORDERS:
        nu[(p, q)] = mu[(p, q)] / torch.pow(denom, 1.0 + (p + q) / 2.0)
        out[f"NormalizedMoment_{p}_{q}"] = z(nu[(p, q)])

    n20, n02, n11 = nu[(2, 0)], nu[(0, 2)], nu[(1, 1)]
    n30, n03, n21, n12 = nu[(3, 0)], nu[(0, 3)], nu[(2, 1)], nu[(1, 2)]
    hu = [
        n20 + n02,
        (n20 - n02) ** 2 + 4 * n11**2,
        (n30 - 3 * n12) ** 2 + (3 * n21 - n03) ** 2,
        (n30 + n12) ** 2 + (n21 + n03) ** 2,
        (n30 - 3 * n12) * (n30 + n12) * ((n30 + n12) ** 2 - 3 * (n21 + n03) ** 2)
        + (3 * n21 - n03) * (n21 + n03) * (3 * (n30 + n12) ** 2 - (n21 + n03) ** 2),
        (n20 - n02) * ((n30 + n12) ** 2 - (n21 + n03) ** 2)
        + 4 * n11 * (n30 + n12) * (n21 + n03),
        (3 * n21 - n03) * (n30 + n12) * ((n30 + n12) ** 2 - 3 * (n21 + n03) ** 2)
        - (n30 - 3 * n12) * (n21 + n03) * (3 * (n30 + n12) ** 2 - (n21 + n03) ** 2),
    ]
    for i, v in enumerate(hu):
        out[f"HuMoment_{i}"] = z(v)

    # inertia tensor (regionprops): [[mu20, -mu11], [-mu11, mu02]] / mu00
    t00, t11, t01 = mu[(2, 0)] / denom, mu[(0, 2)] / denom, -mu[(1, 1)] / denom
    out["InertiaTensor_0_0"] = z(t00)
    out["InertiaTensor_0_1"] = z(t01)
    out["InertiaTensor_1_0"] = z(t01)
    out["InertiaTensor_1_1"] = z(t11)
    tr = (t00 + t11) / 2.0
    det = torch.sqrt(torch.clamp(((t00 - t11) / 2.0) ** 2 + t01**2, min=0.0))
    out["InertiaTensorEigenvalues_0"] = z(tr + det)
    out["InertiaTensorEigenvalues_1"] = z(tr - det)
    out["EquivalentDiameter"] = z(torch.sqrt(4.0 * area / math.pi))
    return out
