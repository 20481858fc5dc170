# Frozen copy of saguaro_tpu_torch/kernels/shape_extra.py (the port's plain forms), part of the
# benchmark's reference: CUDA dispatch removed, imports made local. Not edited
# when the program changes.
"""Distance-transform and convex-hull AreaShape features (port of
``saguaro_tpu/kernels/shape_extra.py``).

* ``_label_edt_sq``: the exact label-aware squared EDT of each object
  pixel (distance to the nearest pixel with a different label), from two
  1-D label-change scans and a bounded horizontal sweep (K5 on CUDA);
* ``radius_features``: CP MeanRadius / MedianRadius / MaximumRadius, the
  median and maximum as exact order statistics of the integer squared
  distances via a coarse/fine per-label histogram (K1 on CUDA);
* ``convex_features``: CP Solidity / Feret diameters / ConvexArea from
  support extreme points over ``n_dirs`` directions, swept over each
  site's first ``max_boundary`` boundary pixels (raster order); the count
  of dropped boundary pixels is returned as ``BoundaryOverflow``.

Every function takes a leading site-batch dimension: labels (B, H, W),
per-object outputs (B, max_cells).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from hcs_bench.reference.plain.kernels import segment_cuda as sc
from hcs_bench.reference.plain.kernels.onehot_reduce import mxu_take_t, onehot_counts, segment_matmul_sums
from hcs_bench.reference.plain.kernels.segment_reduce import _boundary, _flat

__all__ = ["radius_features", "convex_features"]

_FINE = 64  # fine-histogram width of the exact-median hierarchy


def _axis_dist_last(lab: torch.Tensor) -> torch.Tensor:
    """1-D label-aware distance along the last axis: for every pixel, the
    distance to the nearest pixel of its row whose label differs, never
    leaving the array (1e9 when the row holds one label)."""
    n = lab.shape[-1]
    idx = torch.arange(n, dtype=torch.float32, device=lab.device)
    big = 1e9
    change = torch.zeros(lab.shape, dtype=torch.bool, device=lab.device)
    change[..., 1:] = lab[..., 1:] != lab[..., :-1]
    # nearest change at or before i -> a different pixel at (change - 1)
    last = torch.cummax(torch.where(change, idx, torch.full_like(idx, -big)), dim=-1).values
    d_before = idx - last + 1.0
    # nearest change strictly after i -> a different pixel at that index
    after = torch.where(change, idx, torch.full_like(idx, big))
    first = torch.flip(torch.cummin(torch.flip(after, (-1,)), dim=-1).values, (-1,))
    first_after = torch.cat([first[..., 1:], torch.full_like(first[..., :1], big)], dim=-1)
    d_after = first_after - idx
    return torch.clamp(torch.minimum(d_before, d_after), max=big)


def _edt_sweep(v2: torch.Tensor, d2: torch.Tensor, max_radius: int) -> torch.Tensor:
    """The bounded horizontal sweep: K5 for CUDA tensors, the plain form
    for CPU ones."""
    return sc.edt_sweep_plain(v2, d2, max_radius)


def _edt_sweep_inputs(lab: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W) int32 labels -> the sweep's (v2, d2_init): gcol**2 and
    min(grow**2, gcol**2), gcol/grow the label-aware 1-D vertical/horizontal
    distances."""
    gcol = _axis_dist_last(lab.transpose(-1, -2)).transpose(-1, -2)
    grow = _axis_dist_last(lab)
    v2 = gcol * gcol
    return v2, torch.minimum(grow * grow, v2)


def _label_edt_sq(labels: torch.Tensor, max_radius: int) -> torch.Tensor:
    """(B, H, W) labels -> (B, H, W) f32 exact squared Euclidean distance of
    each object pixel to the nearest pixel with a different label
    (background or a touching neighbour); 0 outside objects.

    d2(p) = min(grow(p)^2, min_{|dx| <= R} dx^2 + gcol(row, x + dx)^2) is
    exact whenever the nearest outside pixel lies within R columns."""
    lab = labels.to(torch.int32)
    d2 = _edt_sweep(*_edt_sweep_inputs(lab), max_radius)
    return torch.where(lab > 0, d2, torch.zeros_like(d2))


def _first_true(mask: torch.Tensor, dim: int) -> torch.Tensor:
    """Index of the first True along ``dim`` (0 when there is none), as
    ``jnp.argmax`` of a boolean array."""
    return torch.argmax(mask.to(torch.int32), dim=dim)


def _take1(a: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    return torch.gather(a, 2, i[..., None])[..., 0]


def radius_features(
    labels: torch.Tensor,
    max_cells: int = 1024,
    max_radius: int = 48,
    d2_img: torch.Tensor | None = None,
) -> dict[str, torch.Tensor]:
    """CP AreaShape MeanRadius / MedianRadius / MaximumRadius, exact.

    MedianRadius is the np.median order statistic of the integer squared
    distances (even counts average the two middles), MaximumRadius the
    largest; both come from a coarse (d2 >> 6) per-label histogram that
    locates each rank's coarse bin and one fine (d2 & 63) histogram of the
    pixels in those bins. ``max_radius`` bounds the EDT sweep."""
    lab = labels.to(torch.int32)
    if d2_img is None:
        d2_img = _label_edt_sq(lab, max_radius)
    b = lab.shape[0]
    seg = _flat(lab, max_cells)
    inside_m = lab.reshape(b, -1) > 0
    inside = inside_m.float()
    d2 = d2_img.reshape(b, -1)
    d = torch.sqrt(d2)

    sums = segment_matmul_sums(seg, torch.stack([inside, d * inside], dim=2), max_cells)
    cnt = sums[..., 0]
    mean = sums[..., 1] / torch.clamp(cnt, min=1.0)

    n_coarse = (2 * max_radius * max_radius) // _FINE + 2
    cap = n_coarse * _FINE - 1
    d2i = torch.clamp(d2, max=float(cap)).to(torch.int32)
    c_code = torch.div(d2i, _FINE, rounding_mode="floor")
    f_code = d2i % _FINE
    (coarse,) = onehot_counts(seg, [(c_code, inside_m, n_coarse)], max_cells, label_valid=inside_m)
    cum = torch.cumsum(coarse, dim=2)
    # np.median ranks (1-indexed): lo = floor((n+1)/2), hi = floor(n/2)+1
    lo_rank = torch.floor((cnt + 1.0) / 2.0)
    hi_rank = torch.floor(cnt / 2.0) + 1.0
    lo_bin = _first_true(cum >= lo_rank[..., None], 2)
    hi_bin = _first_true(cum >= hi_rank[..., None], 2)
    mx_bin = _first_true(cum >= cnt[..., None], 2)  # last nonzero bin
    cum_before = cum - coarse
    lo_before = _take1(cum_before, lo_bin)
    hi_before = _take1(cum_before, hi_bin)
    mx_before = _take1(cum_before, mx_bin)
    bins_px = mxu_take_t(torch.stack([lo_bin, hi_bin, mx_bin], dim=2).float(), seg, max_cells)
    bins_px = bins_px.to(torch.int32)
    in_lo = inside_m & (c_code == bins_px[:, 0])
    in_hi = inside_m & (c_code == bins_px[:, 1])
    in_mx = inside_m & (c_code == bins_px[:, 2])
    fine_lo, fine_hi, fine_mx = onehot_counts(
        seg, [(f_code, in_lo, _FINE), (f_code, in_hi, _FINE), (f_code, in_mx, _FINE)], max_cells,
        label_valid=inside_m,
    )
    f_lo = _first_true(torch.cumsum(fine_lo, 2) >= (lo_rank - lo_before)[..., None], 2)
    f_hi = _first_true(torch.cumsum(fine_hi, 2) >= (hi_rank - hi_before)[..., None], 2)
    f_mx = _first_true(torch.cumsum(fine_mx, 2) >= (cnt - mx_before)[..., None], 2)
    med_lo = torch.sqrt((lo_bin * _FINE + f_lo).float())
    med_hi = torch.sqrt((hi_bin * _FINE + f_hi).float())
    median = (med_lo + med_hi) / 2.0
    dmax = torch.sqrt((mx_bin * _FINE + f_mx).float())

    zero = cnt <= 0
    zt = torch.zeros_like(cnt)
    return {
        "MeanRadius": torch.where(zero, zt, mean),
        "MedianRadius": torch.where(zero, zt, median),
        "MaximumRadius": torch.where(zero, zt, dmax),
    }


def convex_features(
    labels: torch.Tensor,
    max_cells: int = 1024,
    n_dirs: int = 72,
    max_boundary: int | None = None,
    area: torch.Tensor | None = None,
) -> dict[str, torch.Tensor]:
    """CP AreaShape Solidity / MaxFeretDiameter / MinFeretDiameter /
    ConvexArea, plus ``BoundaryOverflow`` (B,): the boundary pixels beyond
    the per-site bound ``max_boundary`` (default max(pixels / 8, 4096))
    that the sweep dropped.

    For each direction the support value of every object is the segment
    max of y*cos + x*sin over its boundary pixels (a linear functional
    attains its max on the boundary); the extreme pixel is the smallest
    raster index within 1e-3 of it. The extreme points in angular order
    trace the hull polygon: shoelace area plus half its perimeter plus 1
    (pixels are unit squares). Feret extents pair opposite directions."""
    lab = labels.to(torch.int32)
    b, h, w = lab.shape
    dev = lab.device
    seg = _flat(lab, max_cells)
    if area is None:
        area = segment_matmul_sums(seg, (lab.reshape(b, -1, 1) > 0).float(), max_cells)[..., 0]

    bflat = _boundary(lab).reshape(b, -1)
    k_bound = max_boundary or max(h * w // 8, 4096)
    n_boundary = bflat.sum(dim=1)
    overflow = torch.clamp(n_boundary - k_bound, min=0).float()
    # the first k_bound boundary pixels of each site in raster order
    keep = bflat & (torch.cumsum(bflat.to(torch.int32), dim=1) <= k_bound)
    site_i, pix = torch.nonzero(keep, as_tuple=True)
    yb = torch.div(pix, w, rounding_mode="floor").float()
    xb = (pix % w).float()
    segb = seg[site_i, pix].long()
    key = site_i * max_cells + segb

    thetas = np.linspace(0.0, 2.0 * np.pi, n_dirs, endpoint=False)
    cos_t = torch.tensor(np.cos(thetas), dtype=torch.float32, device=dev)
    sin_t = torch.tensor(np.sin(thetas), dtype=torch.float32, device=dev)
    big = 3.4e38
    seg_mask = (segb > 0)[:, None]
    s_all = yb[:, None] * cos_t[None, :] + xb[:, None] * sin_t[None, :]
    s_masked = torch.where(seg_mask, s_all, torch.full_like(s_all, -big))
    idx = key[:, None].expand(-1, n_dirs)
    sup = torch.full((b * max_cells, n_dirs), -math.inf, dtype=torch.float32, device=dev)
    sup.scatter_reduce_(0, idx, s_masked, "amax", include_self=False)
    at_max = s_masked >= sup[key] - 1e-3
    cand = torch.where(at_max & seg_mask, pix.float()[:, None].expand(-1, n_dirs),
                       torch.full_like(s_all, big))
    pick = torch.full((b * max_cells, n_dirs), math.inf, dtype=torch.float32, device=dev)
    pick.scatter_reduce_(0, idx, cand, "amin", include_self=False)
    sup = sup.view(b, max_cells, n_dirs)
    pick_i = torch.clamp(pick, 0, h * w - 1).to(torch.int64).view(b, max_cells, n_dirs)
    py = torch.div(pick_i, w, rounding_mode="floor").float()
    px = (pick_i % w).float()

    py2 = torch.roll(py, -1, dims=2)
    px2 = torch.roll(px, -1, dims=2)
    hull_area = 0.5 * torch.abs(torch.sum(px * py2 - px2 * py, dim=2))
    hull_perim = torch.sum(torch.sqrt((px2 - px) ** 2 + (py2 - py) ** 2), dim=2)
    hull_area_px = hull_area + 0.5 * hull_perim + 1.0

    extents = sup[..., : n_dirs // 2] + sup[..., n_dirs // 2 :]
    feret_max = extents.amax(dim=2)
    feret_min = extents.amin(dim=2)
    solidity = torch.clamp(area / torch.clamp(hull_area_px, min=1e-6), 0.0, 1.0)
    zero = area <= 0
    zt = torch.zeros_like(area)

    def z(a):
        return torch.where(zero, zt, a)

    return {
        "Solidity": z(solidity),
        "MaxFeretDiameter": z(feret_max),
        "MinFeretDiameter": z(feret_min),
        "ConvexArea": z(hull_area_px),
        "BoundaryOverflow": overflow,
    }
