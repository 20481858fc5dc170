"""Per-object quantile intensities and neighbours (port of
``saguaro_tpu/kernels/objects_extra.py``).

* ``quantile_intensity_features_mc``: CP MeasureObjectIntensity's median,
  MAD and quartiles, exact on the integer (uint16) grid: 16-ary
  hierarchical histograms (4 bits a level) resolve each rank query to the
  exact integer code after 4 passes; every channel and rank query of a pass
  rides one fused per-label histogram (K1 on CUDA). Float images take the
  same rank machinery on a per-object adaptive 16-bit grid;
* ``neighbor_features``: CP MeasureObjectNeighbors' NumberOfNeighbors
  (after growing labels into the background) and PercentTouching, from 4
  directional (label, neighbour) histograms;
* the reference's one-channel forms: ``quantile_intensity_features`` (the
  multichannel one on one channel), ``edge_intensity_features``
  (``segment_stats`` over the 4-neighbour boundary pixels) and
  ``radial_distribution_features`` (FracAtD / MeanFrac by rings of the
  centroid distance over each object's largest one; sums on K3).

Every function takes a leading site-batch dimension: image (B, H, W, C),
or (B, H, W) for the one-channel forms, labels (B, H, W); per-object
outputs (B, max_cells, C) or (B, max_cells).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from saguaro_tpu_torch.kernels import segment_cuda as sc
from saguaro_tpu_torch.kernels.onehot_reduce import mxu_take_t, onehot_counts, segment_matmul_sums
from saguaro_tpu_torch.kernels.segment_reduce import (
    _boundary,
    _coords,
    _flat,
    _segment_reduce,
    _shift,
    _take,
    segment_stats,
)

__all__ = [
    "quantile_intensity_features",
    "quantile_intensity_features_mc",
    "edge_intensity_features",
    "radial_distribution_features",
    "neighbor_features",
]


def quantile_intensity_features(
    image: torch.Tensor, labels: torch.Tensor, max_cells: int = 1024, stats=None,
    integer_grid: bool = True,
) -> dict[str, torch.Tensor]:
    """Median / MAD / lower and upper quartile intensity of one channel:
    image, labels (B, H, W) -> {column: (B, max_cells)}.
    ``stats``: (cnt, vmin, vmax) each (B, max_cells)."""
    mc = quantile_intensity_features_mc(
        image[..., None], labels, max_cells,
        stats=None if stats is None else (stats[0], stats[1][..., None], stats[2][..., None]),
        integer_grid=integer_grid,
    )
    return {k: v[..., 0] for k, v in mc.items()}


def _rank_positions(n: torch.Tensor):
    """CP rank semantics on a sorted object (0-based); n (B, max_cells)
    int32 pixel counts -> (k_med, j25, f25, j75, f75): the median is the
    lower middle order statistic, the quartiles interpolate linearly at
    ``(n - 1) * q`` (numpy percentile convention)."""
    n_f = torch.clamp(n, min=1).float()
    k_med = torch.clamp(torch.div(n + 1, 2, rounding_mode="floor") - 1, min=0)
    pos25 = (n_f - 1.0) * 0.25
    pos75 = (n_f - 1.0) * 0.75
    j25 = torch.floor(pos25).to(torch.int32)
    j75 = torch.floor(pos75).to(torch.int32)
    return k_med, j25, pos25 - j25, j75, pos75 - j75


def _rank_step(cum: torch.Tensor, rank: torch.Tensor):
    """cum (B, max_cells, n_bins, C) cumulative counts; rank (B, max_cells,
    C) 0-based rank remaining -> (selected bin (B, max_cells, C) int32, rank
    remaining within that bin (B, max_cells, C) f32)."""
    r = rank[:, :, None, :].float()
    sel = torch.argmax((cum > r).to(torch.int32), dim=2)
    padded = torch.cat([torch.zeros_like(cum[:, :, :1]), cum], dim=2)
    below = torch.gather(padded, 2, sel[:, :, None, :])[:, :, 0, :]
    return sel.to(torch.int32), rank.float() - below


def _two_level_ranks(seg, inside, codes16, ranks, nm1, n_ch, max_cells, bits=(4, 4, 4, 4)):
    """Exact order statistics of 16-bit codes via hierarchical histograms.

    codes16 (B, C, N) int32 in [0, 65535]; ranks: list of (B, max_cells)
    0-based rank queries. Level 1 bins the top ``bits[0]`` bits; each later
    level gathers every object's selected prefix per query (one K2 gather),
    keeps the pixels whose high bits match it and bins the next bits.
    Returns [(B, max_cells, C) f32 codes, ...] per query."""
    b = seg.shape[0]
    nq = len(ranks)
    shift = 16 - bits[0]
    h1 = onehot_counts(seg, [(codes16[:, c] >> shift, inside, 1 << bits[0]) for c in range(n_ch)],
                       max_cells, label_valid=inside)
    cum1 = torch.cumsum(torch.stack(h1, dim=-1), dim=2)  # (B, mc, nb0, C)
    prefix, rems = [], []
    for r in ranks:
        rr = torch.minimum(torch.clamp(r, min=0), nm1).float()[..., None].expand(b, max_cells, n_ch)
        s, rem = _rank_step(cum1, rr)
        prefix.append(s)
        rems.append(rem)

    for nbits in bits[1:]:
        nb = 1 << nbits
        new_shift = shift - nbits
        sel_tab = torch.cat(prefix, dim=2).float()
        p_sel = torch.round(mxu_take_t(sel_tab, seg, max_cells)).to(torch.int32)
        entries = []
        for qi in range(nq):
            for c in range(n_ch):
                m = inside & ((codes16[:, c] >> shift) == p_sel[:, qi * n_ch + c])
                entries.append(((codes16[:, c] >> new_shift) & (nb - 1), m, nb))
        hs = onehot_counts(seg, entries, max_cells, label_valid=inside)
        new_prefix, new_rems = [], []
        for qi in range(nq):
            cum = torch.cumsum(torch.stack(hs[qi * n_ch : (qi + 1) * n_ch], dim=-1), dim=2)
            s, rem = _rank_step(cum, rems[qi])
            new_prefix.append(prefix[qi] * nb + s)
            new_rems.append(rem)
        prefix, rems, shift = new_prefix, new_rems, new_shift
    return [p.float() for p in prefix]


def _rank_queries(n: torch.Tensor):
    k_med, j25, f25, j75, f75 = _rank_positions(n)
    nm1 = torch.clamp(n - 1, min=0)
    queries = [k_med, j25, torch.minimum(j25 + 1, nm1), j75, torch.minimum(j75 + 1, nm1)]
    return queries, nm1, f25[..., None], f75[..., None]


def quantile_intensity_features_mc(
    image: torch.Tensor,
    labels: torch.Tensor,
    max_cells: int = 1024,
    stats=None,
    ranges=None,
    integer_grid: bool = True,
) -> dict[str, torch.Tensor]:
    """Median / MAD / lower and upper quartile intensity per object and
    channel, (B, max_cells, C) each.

    ``stats``: (cnt (B, mc), vmin, vmax (B, mc, C)) from the fused
    measurement; ``ranges``: pregathered per-pixel (vmin, vrange), each
    (B, C, N), shared with texture (adaptive path only).
    ``integer_grid=False`` ranks on a per-object adaptive 16-bit grid
    (error <= object range / 131070)."""
    b, h, w, n_ch = image.shape
    seg = _flat(labels, max_cells)
    inside = labels.reshape(b, -1) > 0
    v_t = image.float().permute(0, 3, 1, 2).reshape(b, n_ch, h * w)
    if stats is None:
        stats = _segment_stats(v_t, seg, inside, max_cells)
    cnt = stats[0]
    n = torch.round(cnt).to(torch.int32)
    queries, nm1, f25, f75 = _rank_queries(n)
    if not integer_grid:
        return _quantile_adaptive_mc(v_t, seg, inside, stats, ranges, queries, nm1, f25, f75,
                                     max_cells)

    vi = torch.clamp(torch.round(v_t), 0.0, 65535.0).to(torch.int32)
    v_med, v25lo, v25hi, v75lo, v75hi = _two_level_ranks(
        seg, inside, vi, queries, nm1, n_ch, max_cells
    )
    lo = v25lo * (1.0 - f25) + v25hi * f25
    hi = v75lo * (1.0 - f75) + v75hi * f75
    # MAD: the order statistic at the median index of |v - median|
    pmed = torch.round(mxu_take_t(v_med, seg, max_cells)).to(torch.int32)
    (mad,) = _two_level_ranks(seg, inside, (vi - pmed).abs(), queries[:1], nm1, n_ch, max_cells)

    zero = (n <= 0)[..., None]
    zt = torch.zeros_like(v_med)
    return {
        "MedianIntensity": torch.where(zero, zt, v_med),
        "MADIntensity": torch.where(zero, zt, mad),
        "LowerQuartileIntensity": torch.where(zero, zt, lo),
        "UpperQuartileIntensity": torch.where(zero, zt, hi),
    }


def _segment_stats(v_t, seg, inside, max_cells):
    """(cnt, vmin, vmax) per label of (B, C, N) values; empty labels get 0."""
    b, n_ch, n = v_t.shape
    cnt = torch.zeros((b, max_cells), dtype=torch.float32, device=v_t.device)
    cnt.scatter_add_(1, seg.long(), inside.float())
    idx = seg.long()[:, None, :].expand(b, n_ch, n)
    ins = inside[:, None, :]
    vmin = torch.full((b, n_ch, max_cells), float("inf"), device=v_t.device).scatter_reduce_(
        2, idx, torch.where(ins, v_t, torch.full_like(v_t, float("inf"))), "amin")
    vmax = torch.full((b, n_ch, max_cells), -float("inf"), device=v_t.device).scatter_reduce_(
        2, idx, torch.where(ins, v_t, torch.full_like(v_t, -float("inf"))), "amax")
    vmin = torch.where(torch.isfinite(vmin), vmin, torch.zeros_like(vmin)).transpose(1, 2)
    vmax = torch.where(torch.isfinite(vmax), vmax, torch.zeros_like(vmax)).transpose(1, 2)
    return cnt, vmin, vmax


def _quantile_adaptive_mc(v_t, seg, inside, stats, ranges, queries, nm1, f25, f75, max_cells):
    """Float-image path: the integer path's rank semantics on the grid
    ``round((v - vmin) / range * 65535)`` of each object."""
    n_ch = v_t.shape[1]
    cnt, vmin, vmax = stats
    vrange = torch.clamp(vmax - vmin, min=1e-12)
    if ranges is None:
        gq = mxu_take_t(torch.cat([vmin, vrange], dim=2), seg, max_cells)
        ranges = (gq[:, :n_ch], gq[:, n_ch:])
    pmin, prange = ranges
    prange = torch.clamp(prange, min=1e-12)
    t = torch.clamp((v_t - pmin) / prange, 0.0, 1.0)
    codes = torch.round(t * 65535.0).to(torch.int32)

    def decode(c):
        return vmin + c / 65535.0 * vrange

    c_med, c25lo, c25hi, c75lo, c75hi = _two_level_ranks(
        seg, inside, codes, queries, nm1, n_ch, max_cells
    )
    med = decode(c_med)
    lo = decode(c25lo) * (1.0 - f25) + decode(c25hi) * f25
    hi = decode(c75lo) * (1.0 - f75) + decode(c75hi) * f75
    pmed = mxu_take_t(med, seg, max_cells)
    dev = torch.clamp((v_t - pmed).abs() / prange, 0.0, 1.0)
    dcodes = torch.round(dev * 65535.0).to(torch.int32)
    (c_mad,) = _two_level_ranks(seg, inside, dcodes, queries[:1], nm1, n_ch, max_cells)
    mad = c_mad / 65535.0 * vrange

    zero = (cnt <= 0)[..., None]
    zt = torch.zeros_like(med)
    return {
        "MedianIntensity": torch.where(zero, zt, med),
        "MADIntensity": torch.where(zero, zt, mad),
        "LowerQuartileIntensity": torch.where(zero, zt, lo),
        "UpperQuartileIntensity": torch.where(zero, zt, hi),
    }


def neighbor_features(
    labels: torch.Tensor, max_cells: int = 1024, distance: int = 5
) -> dict[str, torch.Tensor]:
    """CP MeasureObjectNeighbors core, (B, max_cells) each:
    NumberOfNeighbors within ``distance`` pixels (labels grown
    ``distance // 2`` rings into the background first) and PercentTouching
    (the share of an object's boundary pixels whose grown 4-neighbourhood
    meets another object). Ids >= max_cells fold into the ignored slot 0."""
    lab = labels.to(torch.int32)
    b = lab.shape[0]
    grown = lab
    for _ in range(max(distance // 2, 0)):
        neigh = F.max_pool2d(grown.float()[:, None], 3, stride=1, padding=1)[:, 0].to(torch.int32)
        grown = torch.where(grown == 0, neigh, grown)

    def fold(a):
        return torch.where((a > 0) & (a < max_cells), a, torch.zeros_like(a))

    me = fold(grown)
    touching = torch.zeros(grown.shape, dtype=torch.bool, device=grown.device)
    codes = []
    for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        other = fold(_shift(grown, dy, dx, 0))
        is_pair = (me > 0) & (other > 0) & (me != other)
        touching = touching | is_pair
        codes.append((other.reshape(b, -1), is_pair.reshape(b, -1), max_cells))
    hists = onehot_counts(me.reshape(b, -1), codes, max_cells, label_valid=(me > 0).reshape(b, -1))
    n_neighbors = (sum(hists) > 0).float().sum(dim=2)

    boundary = _boundary(lab).reshape(b, -1)
    seg = _flat(lab, max_cells)
    zeros = torch.zeros_like(seg)
    b_cnt, t_cnt = onehot_counts(
        seg, [(zeros, boundary, 1), (zeros, boundary & touching.reshape(b, -1), 1)], max_cells,
        label_valid=boundary,
    )
    pct = 100.0 * t_cnt[..., 0] / torch.clamp(b_cnt[..., 0], min=1.0)
    return {"NumberOfNeighbors": n_neighbors, "PercentTouching": pct}


def edge_intensity_features(image: torch.Tensor, labels: torch.Tensor, max_cells: int = 1024):
    """CP's Edge intensity set of one channel: ``segment_stats`` over each
    object's boundary pixels (a 4-neighbour of another label, the image
    border counting as background); the variance is the reference's
    uncentred ``sumsq / n - mean**2``. image, labels (B, H, W) ->
    {column: (B, max_cells)}."""
    lab = labels.to(torch.int32)
    edge_labels = torch.where(_boundary(lab), lab, torch.zeros_like(lab))
    cnt, s, ss, vmin, vmax = segment_stats(image, edge_labels, max_cells)
    denom = torch.clamp(cnt, min=1.0)
    mean = s / denom
    var = torch.clamp(ss / denom - mean * mean, min=0.0)
    zero = cnt <= 0

    def z(a):
        return torch.where(zero, torch.zeros_like(a), a)

    return {
        "IntegratedIntensityEdge": z(s),
        "MeanIntensityEdge": z(mean),
        "StdIntensityEdge": z(torch.sqrt(var)),
        "MinIntensityEdge": z(vmin),
        "MaxIntensityEdge": z(vmax),
    }


def radial_distribution_features(
    image: torch.Tensor, labels: torch.Tensor, max_cells: int = 1024, n_rings: int = 4
) -> dict[str, torch.Tensor]:
    """CP MeasureObjectIntensityDistribution core of one channel, rings of
    the centroid distance over the object's largest one: FracAtD (the
    ring's share of the object's intensity) and MeanFrac (that over the
    ring's share of the object's pixels). image, labels (B, H, W) ->
    {"FracAtD", "MeanFrac"} each (B, max_cells, n_rings). A ring is a
    floor, so the distance is rounded as the reference's program rounds it
    (one fused multiply-add, a correctly rounded square root)."""
    b, h, w = labels.shape
    seg = _flat(labels, max_cells)
    inside = (labels.reshape(b, -1) > 0).float()
    v = image.reshape(b, -1).float() * inside
    yf, xf = _coords(b, h, w, labels.device)
    sums = segment_matmul_sums(seg, torch.stack([inside, yf * inside, xf * inside], dim=-1),
                               max_cells)
    cnt = sums[..., 0]
    denom = torch.clamp(cnt, min=1.0)
    dy = yf - _take(sums[..., 1] / denom, seg)
    dx = xf - _take(sums[..., 2] / denom, seg)
    dist = sc.sqrt32(sc.fma32(dy, dy, dx * dx))
    dmax = _segment_reduce(torch.where(inside > 0, dist, torch.full_like(dist, -1.0)), seg,
                        max_cells, "amax")
    dnorm = dist / torch.clamp(_take(dmax, seg), min=1e-6)
    ring = torch.clamp((dnorm * n_rings).to(torch.int32), 0, n_rings - 1)
    keys = seg * n_rings + ring
    ring_sums = segment_matmul_sums(keys, torch.stack([v, inside], dim=-1), max_cells * n_rings)
    ring_sums = ring_sums.view(b, max_cells, n_rings, 2)
    ring_int, ring_cnt = ring_sums[..., 0], ring_sums[..., 1]
    total_int = torch.clamp(ring_int.sum(dim=2, keepdim=True), min=1e-12)
    frac_at_d = ring_int / total_int
    pix_frac = ring_cnt / torch.clamp(cnt[..., None], min=1.0)
    mean_frac = frac_at_d / torch.clamp(pix_frac, min=1e-12)
    zero = (cnt <= 0)[..., None]
    return {
        "FracAtD": torch.where(zero, torch.zeros_like(frac_at_d), frac_at_d),
        "MeanFrac": torch.where(zero, torch.zeros_like(mean_frac), mean_frac),
    }
