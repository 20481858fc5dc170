"""Multichannel per-object statistics (port of
``saguaro_tpu/kernels/multichannel.py``): every channel, and every channel
pair, carried as lanes of a few passes per object set.

* ``multichannel_stats``: the intensity and correlation families, two
  ``segment_matmul_sums`` (linear sums, centred quadratics) and segment
  min / max / argmax;
* ``edge_intensity_multichannel``: the Edge family over boundary pixels;
* ``radial_distribution_multichannel``: centroid ring binning, one keyed sum
  of the count and every channel.

Sums go through ``segment_matmul_sums`` (K3 on CUDA), min / max / argmax
through ``scatter_reduce``. ``fused_object_features`` computes the same
families inside its lane scans; these functions are its oracles, as in the
reference.

Every function takes a leading site-batch dimension: image (B, H, W, C),
labels (B, H, W); outputs are (B, max_cells, ...).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from saguaro_tpu_torch.kernels.onehot_reduce import segment_matmul_sums
from saguaro_tpu_torch.kernels.segment_cuda import _pairs
from saguaro_tpu_torch.kernels.segment_reduce import _coords, _flat, _segment_reduce, _take

__all__ = [
    "multichannel_stats",
    "edge_intensity_multichannel",
    "radial_distribution_multichannel",
]

_BIG = 3.4e38


def multichannel_stats(image: torch.Tensor, labels: torch.Tensor, max_cells: int = 1024):
    """Intensity and correlation families of every channel at once: image
    (B, H, W, C), labels (B, H, W) -> (intensity {column: (B, max_cells,
    C)}, correlation {(a, b): (Correlation, Slope) each (B, max_cells)})."""
    b, h, w, n_ch = image.shape
    seg = _flat(labels, max_cells)
    inside_m = labels.reshape(b, -1) > 0
    inside = inside_m.float()
    vr = image.reshape(b, h * w, n_ch).float()
    v = vr * inside[..., None]
    yf, xf = _coords(b, h, w, image.device)

    # pass 1: [1, y, x, v_c..., y v_c..., x v_c...], 3 + 3C lanes
    payload1 = torch.cat([torch.stack([inside, yf * inside, xf * inside], dim=-1),
                          v, yf[..., None] * v, xf[..., None] * v], dim=-1)
    sums = segment_matmul_sums(seg, payload1, max_cells)
    del payload1
    cnt, sy, sx = sums[..., 0], sums[..., 1], sums[..., 2]
    s = sums[..., 3 : 3 + n_ch]
    wy = sums[..., 3 + n_ch : 3 + 2 * n_ch]
    wx = sums[..., 3 + 2 * n_ch : 3 + 3 * n_ch]
    denom = torch.clamp(cnt, min=1.0)
    mean = s / denom[..., None]

    # pass 2: centred quadratics, C squares + C(C-1)/2 cross products
    vc = (vr - _take(mean, seg)) * inside[..., None]
    pairs = _pairs(n_ch)
    payload2 = torch.cat([vc * vc] + ([torch.stack([vc[..., a] * vc[..., c] for a, c in pairs],
                                                   dim=-1)] if pairs else []), dim=-1)
    del vc
    sums2 = segment_matmul_sums(seg, payload2, max_cells)
    del payload2
    var = torch.clamp(sums2[..., :n_ch] / denom[..., None], min=0.0)

    # min / max / argmax
    ins = inside_m[..., None]
    vmin = _segment_reduce(torch.where(ins, vr, torch.full_like(vr, _BIG)), seg, max_cells, "amin")
    vmax = _segment_reduce(torch.where(ins, vr, torch.full_like(vr, -_BIG)), seg, max_cells, "amax")
    at_max = ins & (vr >= _take(vmax, seg))
    idx = torch.arange(h * w, dtype=torch.float32, device=image.device)[None, :, None]
    pick = _segment_reduce(torch.where(at_max, idx.expand_as(vr), torch.full_like(vr, float(h * w))),
                           seg, max_cells, "amin")
    pick_i = torch.clamp(pick, 0, h * w - 1).to(torch.int32)
    max_y = torch.div(pick_i, w, rounding_mode="floor").float()
    max_x = (pick_i % w).float()

    sdenom = torch.clamp(s, min=1e-12)
    disp = torch.sqrt(((sy / denom)[..., None] - wy / sdenom) ** 2
                      + ((sx / denom)[..., None] - wx / sdenom) ** 2)
    zero = (cnt <= 0)[..., None]

    def z(a):
        return torch.where(zero, torch.zeros_like(a), a)

    intensity = {
        "IntegratedIntensity": z(s),
        "MeanIntensity": z(mean),
        "StdIntensity": z(torch.sqrt(var)),
        "MinIntensity": z(vmin),
        "MaxIntensity": z(vmax),
        "MassDisplacement": z(disp),
        "CenterMassIntensity_Y": z(wy / sdenom),
        "CenterMassIntensity_X": z(wx / sdenom),
        "MaxIntensity_Y": z(max_y),
        "MaxIntensity_X": z(max_x),
    }
    zero1 = cnt <= 1
    corr_out = {}
    for i, (a, c) in enumerate(pairs):
        cov = sums2[..., n_ch + i] / denom
        corr = cov / torch.clamp(torch.sqrt(var[..., a] * var[..., c]), min=1e-12)
        slope = cov / torch.clamp(var[..., a], min=1e-12)
        corr_out[(a, c)] = (torch.where(zero1, torch.zeros_like(corr), corr),
                            torch.where(zero1, torch.zeros_like(slope), slope))
    return intensity, corr_out


def edge_intensity_multichannel(image: torch.Tensor, labels: torch.Tensor, max_cells: int = 1024):
    """CP's Edge intensity family of every channel: statistics over each
    object's boundary pixels (a pixel whose 4-neighbour differs), image
    (B, H, W, C), labels (B, H, W) -> {column: (B, max_cells, C)}."""
    b, h, w, n_ch = image.shape
    lab = labels.to(torch.int32)
    pad = F.pad(lab, (1, 1, 1, 1), value=0)
    boundary = ((pad[:, :-2, 1:-1] != lab) | (pad[:, 2:, 1:-1] != lab)
                | (pad[:, 1:-1, :-2] != lab) | (pad[:, 1:-1, 2:] != lab)) & (lab > 0)
    flat = torch.where(boundary, lab, torch.zeros_like(lab)).reshape(b, -1)
    seg = torch.where((flat > 0) & (flat < max_cells), flat, torch.zeros_like(flat))
    on = flat > 0
    onf = on.float()
    vr = image.reshape(b, h * w, n_ch).float()
    v = vr * onf[..., None]

    sums = segment_matmul_sums(seg, torch.cat([onf[..., None], v], dim=-1), max_cells)
    cnt, s = sums[..., 0], sums[..., 1:]
    denom = torch.clamp(cnt, min=1.0)
    mean = s / denom[..., None]
    vc = (vr - _take(mean, seg)) * onf[..., None]
    var = torch.clamp(segment_matmul_sums(seg, vc * vc, max_cells) / denom[..., None], min=0.0)
    del vc
    ins = on[..., None]
    vmin = _segment_reduce(torch.where(ins, vr, torch.full_like(vr, _BIG)), seg, max_cells, "amin")
    vmax = _segment_reduce(torch.where(ins, vr, torch.full_like(vr, -_BIG)), seg, max_cells, "amax")
    zero = (cnt <= 0)[..., None]

    def z(a):
        return torch.where(zero, torch.zeros_like(a), a)

    return {
        "IntegratedIntensityEdge": z(s),
        "MeanIntensityEdge": z(mean),
        "StdIntensityEdge": z(torch.sqrt(var)),
        "MinIntensityEdge": z(vmin),
        "MaxIntensityEdge": z(vmax),
    }


def radial_distribution_multichannel(image: torch.Tensor, labels: torch.Tensor,
                                     max_cells: int = 1024, n_rings: int = 4):
    """CP's radial distribution of every channel with centroid ring binning
    (a pixel's ring from its distance to the centroid over the object's
    largest such distance): image (B, H, W, C), labels (B, H, W) ->
    {"FracAtD", "MeanFrac"} each (B, max_cells, n_rings, C)."""
    b, h, w, n_ch = image.shape
    seg = _flat(labels, max_cells)
    inside = (labels.reshape(b, -1) > 0).float()
    v = image.reshape(b, h * w, n_ch).float() * inside[..., None]
    yf, xf = _coords(b, h, w, image.device)
    sums = segment_matmul_sums(seg, torch.stack([inside, yf * inside, xf * inside], dim=-1),
                               max_cells)
    cnt = sums[..., 0]
    denom = torch.clamp(cnt, min=1.0)
    cy, cx = sums[..., 1] / denom, sums[..., 2] / denom
    dy = yf - _take(cy, seg)
    dx = xf - _take(cx, seg)
    dist = torch.sqrt(dy * dy + dx * dx)
    dmax = _segment_reduce(torch.where(inside > 0, dist, torch.full_like(dist, -1.0))[..., None],
                           seg, max_cells, "amax")[..., 0]
    dnorm = dist / torch.clamp(_take(dmax, seg), min=1e-6)
    ring = torch.clamp((dnorm * n_rings).to(torch.int32), 0, n_rings - 1)
    keys = seg * n_rings + ring
    ring_sums = segment_matmul_sums(keys, torch.cat([inside[..., None], v], dim=-1),
                                    max_cells * n_rings).reshape(b, max_cells, n_rings, 1 + n_ch)
    ring_cnt, ring_int = ring_sums[..., 0], ring_sums[..., 1:]
    total_int = torch.clamp(ring_int.sum(dim=2, keepdim=True), min=1e-12)
    frac_at_d = ring_int / total_int
    pix_frac = ring_cnt / torch.clamp(cnt[..., None], min=1.0)
    mean_frac = frac_at_d / torch.clamp(pix_frac[..., None], min=1e-12)
    zero = (cnt <= 0)[..., None, None]
    return {
        "FracAtD": torch.where(zero, torch.zeros_like(frac_at_d), frac_at_d),
        "MeanFrac": torch.where(zero, torch.zeros_like(mean_frac), mean_frac),
    }
