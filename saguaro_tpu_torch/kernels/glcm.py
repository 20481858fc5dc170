"""Per-object Haralick texture features from grey-level co-occurrence
matrices, CP MeasureTexture (port of ``saguaro_tpu/kernels/glcm.py``).

Intensities are quantized to ``levels`` grey levels over each object's own
min..max range. For each of 4 directions at distance ``scale``, every pixel
pair inside one object adds to that object's co-occurrence histogram; the
symmetrized histogram (C + C^T) needs only the sorted pair, so the pairs
are counted in L(L+1)/2 triangular columns. All channels x directions
(20 code planes at 5 channels) ride one fused per-label histogram (K1 on
CUDA). The 13 Haralick statistics are closed forms over the normalized
(L, L) matrices.

``object_glcm`` is the reference's one-channel form (its own per-object
ranges, or the ``stats`` or ``quantized`` it is given), counted by the same
histogram; ``object_glcm_scatter`` counts the full L x L matrices with a
plain scatter, the formulation the reference keeps for parity tests.

Every function takes a leading site-batch dimension.
"""

from __future__ import annotations

import numpy as np
import torch

from saguaro_tpu_torch.kernels.onehot_reduce import mxu_take_t, onehot_counts
from saguaro_tpu_torch.kernels.segment_reduce import _flat, segment_stats

__all__ = [
    "quantize_channels", "glcm_pair_codes", "object_glcm", "object_glcm_multichannel",
    "object_glcm_scatter", "haralick_features", "HARALICK_NAMES",
]

HARALICK_NAMES = (
    "AngularSecondMoment",
    "Contrast",
    "Correlation",
    "Variance",
    "InverseDifferenceMoment",
    "SumAverage",
    "SumVariance",
    "SumEntropy",
    "Entropy",
    "DifferenceVariance",
    "DifferenceEntropy",
    "InfoMeas1",
    "InfoMeas2",
)

# 4 standard directions (dy, dx) at unit scale; multiplied by the distance
_DIRECTIONS = ((0, 1), (1, 1), (1, 0), (1, -1))


def quantize_channels(
    image: torch.Tensor, labels: torch.Tensor, levels: int, ranges: tuple
) -> torch.Tensor:
    """(B, H, W, C) image -> (B, C, H, W) int32 per-object grey levels
    ``clip(floor((v - vmin) / vrange * levels), 0, levels - 1)``;
    ``ranges`` = per-pixel (vmin, vrange), each (B, C, H*W), gathered once
    for texture and quantiles."""
    b, h, w, n_ch = image.shape
    pmin, prange = ranges
    img = image.float().permute(0, 3, 1, 2)
    q = torch.floor((img - pmin.view(b, n_ch, h, w)) / prange.view(b, n_ch, h, w) * levels)
    return torch.clamp(q, 0, levels - 1).to(torch.int32)


def _n_tri(levels: int) -> int:
    return levels * (levels + 1) // 2


def _shifted(a: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """out[..., y, x] = a[..., y + dy, x + dx], ``fill`` outside."""
    h, w = a.shape[-2:]
    pad = (max(-dx, 0), max(dx, 0), max(-dy, 0), max(dy, 0))
    p = torch.nn.functional.pad(a, pad, value=fill)
    y0, x0 = max(dy, 0), max(dx, 0)
    return p[..., y0 : y0 + h, x0 : x0 + w]


def _tri_expand(hist: torch.Tensor, levels: int) -> torch.Tensor:
    """(..., L(L+1)/2) triangular counts -> (..., L, L) symmetrized GLCM:
    off-diagonal entries hold both pair orders' count, the diagonal twice
    its count (C + C^T doubles it)."""
    qq = np.arange(levels)
    lo = np.minimum(qq[:, None], qq[None, :])
    hi = np.maximum(qq[:, None], qq[None, :])
    tri = torch.as_tensor((hi * (hi + 1) // 2 + lo).reshape(-1), device=hist.device)
    diag = torch.as_tensor((qq[:, None] == qq[None, :]).astype(np.float32), device=hist.device)
    sym = hist[..., tri].reshape(*hist.shape[:-1], levels, levels)
    return sym * (1.0 + diag)


def _neighbour_pairs(lab, inside, q, distance):
    """Per direction: the grey level at (y + dy, x + dx) and whether the
    pair lies inside one object; lab (B, H, W) slot labels, q (B, H, W)."""
    for dy, dx in _DIRECTIONS:
        dy, dx = dy * distance, dx * distance
        q2 = _shifted(q, dy, dx, 0)
        lab2 = _shifted(lab, dy, dx, -1)
        inside2 = _shifted(inside, dy, dx, False)
        yield q2, inside & inside2 & (lab == lab2)


def glcm_pair_codes(
    labels: torch.Tensor, max_cells: int, levels: int, distance: int, quantized: torch.Tensor
) -> tuple[torch.Tensor, list[tuple[torch.Tensor, torch.Tensor, int]]]:
    """The co-occurrence histogram's inputs: (B, N) slot labels and one
    (triangular pair code (B, N), valid (B, N), L(L+1)/2) plane per channel
    and direction, as ``onehot_counts`` takes them (C x 4 planes)."""
    b, n_ch = quantized.shape[:2]
    lab = _flat(labels, max_cells).reshape(labels.shape)
    inside = labels > 0
    nt = _n_tri(levels)
    planes = []
    for c in range(n_ch):
        q = quantized[:, c]
        for q2, ok in _neighbour_pairs(lab, inside, q, distance):
            lo = torch.minimum(q, q2)
            hi = torch.maximum(q, q2)
            planes.append(((hi * (hi + 1) // 2 + lo).reshape(b, -1), ok.reshape(b, -1), nt))
    return lab.reshape(b, -1), planes


def _quantize(image: torch.Tensor, labels: torch.Tensor, max_cells: int, levels: int,
              stats=None) -> torch.Tensor:
    """(B, H, W) image -> (B, H, W) int32 grey levels over each object's
    own range: ``stats`` = (vmin, vmax) each (B, max_cells), else
    ``segment_stats``'; the per-pixel (vmin, vrange) are one gather (K2 on
    CUDA)."""
    if stats is None:
        _, _, _, vmin, vmax = segment_stats(image, labels, max_cells)
    else:
        vmin, vmax = stats
    vrange = torch.clamp(vmax - vmin, min=1e-12)
    g = mxu_take_t(torch.stack([vmin, vrange], dim=2), _flat(labels, max_cells), max_cells)
    return quantize_channels(image[..., None], labels, levels, (g[:, :1], g[:, 1:]))[:, 0]


def object_glcm(
    image: torch.Tensor,
    labels: torch.Tensor,
    max_cells: int = 1024,
    levels: int = 16,
    distance: int = 3,
    stats=None,
    quantized: torch.Tensor | None = None,
) -> torch.Tensor:
    """(B, H, W) image + labels -> (B, 4, max_cells, L, L) normalized
    symmetric GLCMs of one channel, one a direction; the four directions'
    pairs are counted by one fused histogram (K1 on CUDA). ``stats``:
    (vmin, vmax) each (B, max_cells), e.g. the fused measurement's;
    ``quantized``: (B, H, W) grey levels already made, which skip the
    range lookup."""
    q = _quantize(image, labels, max_cells, levels, stats) if quantized is None else quantized
    return object_glcm_multichannel(labels, max_cells, levels, distance, q[:, None])[:, 0]


def object_glcm_scatter(
    image: torch.Tensor,
    labels: torch.Tensor,
    max_cells: int = 1024,
    levels: int = 16,
    distance: int = 3,
) -> torch.Tensor:
    """``object_glcm`` by a plain scatter of every (label, q, q2) pair into
    full L x L counts, symmetrized as C + C^T; kept for parity tests."""
    b = labels.shape[0]
    l2 = levels * levels
    lab = _flat(labels, max_cells).reshape(labels.shape)
    q = _quantize(image, labels, max_cells, levels)
    site = torch.arange(b, device=labels.device)[:, None, None] * (max_cells * l2)
    out = []
    for q2, ok in _neighbour_pairs(lab, labels > 0, q, distance):
        idx = (site + lab * l2 + q * levels + q2).reshape(-1).long()
        counts = torch.zeros(b * max_cells * l2, dtype=torch.float32, device=labels.device)
        counts.index_add_(0, idx, ok.reshape(-1).float())
        counts = counts.view(b, max_cells, levels, levels)
        sym = counts + counts.transpose(2, 3)
        out.append(sym / torch.clamp(sym.sum(dim=(2, 3), keepdim=True), min=1e-12))
    return torch.stack(out, dim=1)


def object_glcm_multichannel(
    labels: torch.Tensor, max_cells: int, levels: int, distance: int, quantized: torch.Tensor
) -> torch.Tensor:
    """(B, H, W) labels + (B, C, H, W) grey levels (``quantize_channels``)
    -> (B, C, 4, max_cells, L, L) normalized symmetric GLCMs. A pair counts
    when both pixels lie inside one object (ids >= max_cells count in the
    ignored slot 0)."""
    b, n_ch = quantized.shape[:2]
    lab, planes = glcm_pair_codes(labels, max_cells, levels, distance, quantized)
    # every pair plane needs its first pixel inside an object
    hs = onehot_counts(lab, planes, max_cells, label_valid=(labels > 0).reshape(b, -1))
    sym = _tri_expand(torch.stack(hs, dim=1), levels)  # (B, C*4, mc, L, L)
    sym = sym.view(b, n_ch, 4, max_cells, levels, levels)
    total = sym.sum(dim=(4, 5), keepdim=True)
    return sym / torch.clamp(total, min=1e-12)


def haralick_features(glcm: torch.Tensor) -> dict[str, torch.Tensor]:
    """(..., L, L) normalized GLCMs -> the 13 Haralick statistics (...)."""
    L = glcm.shape[-1]
    p = glcm
    eps = 1e-12
    i = torch.arange(L, dtype=torch.float32, device=p.device)
    ii = i[:, None]
    jj = i[None, :]

    px = p.sum(dim=-1)
    py = p.sum(dim=-2)
    mux = (px * i).sum(dim=-1)
    muy = (py * i).sum(dim=-1)
    sigx = torch.sqrt(torch.clamp((px * i**2).sum(dim=-1) - mux**2, min=0.0))
    sigy = torch.sqrt(torch.clamp((py * i**2).sum(dim=-1) - muy**2, min=0.0))

    asm = (p * p).sum(dim=(-2, -1))
    contrast = (p * (ii - jj) ** 2).sum(dim=(-2, -1))
    corr_num = (p * ii * jj).sum(dim=(-2, -1)) - mux * muy
    correlation = corr_num / torch.clamp(sigx * sigy, min=eps)
    # Haralick "Variance" (sum of squares) uses the overall GLCM mean
    mu = (p * ii).sum(dim=(-2, -1))
    variance = (p * (ii - mu[..., None, None]) ** 2).sum(dim=(-2, -1))
    idm = (p / (1.0 + (ii - jj) ** 2)).sum(dim=(-2, -1))

    # p_{x+y}(k), k = i+j in [0, 2L-2]; p_{x-y}(k), k = |i-j| in [0, L-1]
    ksum = (ii + jj).to(torch.int64).reshape(-1)
    kdiff = (ii - jj).abs().to(torch.int64).reshape(-1)
    flat = p.reshape(*p.shape[:-2], L * L)
    ps = torch.zeros((*p.shape[:-2], 2 * L - 1), dtype=p.dtype, device=p.device)
    ps.index_add_(ps.dim() - 1, ksum, flat)
    pd = torch.zeros((*p.shape[:-2], L), dtype=p.dtype, device=p.device)
    pd.index_add_(pd.dim() - 1, kdiff, flat)
    ks = torch.arange(2 * L - 1, dtype=torch.float32, device=p.device)
    kd = torch.arange(L, dtype=torch.float32, device=p.device)

    sum_avg = (ps * ks).sum(dim=-1)
    sum_ent = -(ps * torch.log2(ps + eps)).sum(dim=-1)
    sum_var = (ps * (ks - sum_avg[..., None]) ** 2).sum(dim=-1)
    ent = -(p * torch.log2(p + eps)).sum(dim=(-2, -1))
    diff_avg = (pd * kd).sum(dim=-1)
    diff_var = (pd * (kd - diff_avg[..., None]) ** 2).sum(dim=-1)
    diff_ent = -(pd * torch.log2(pd + eps)).sum(dim=-1)

    hx = -(px * torch.log2(px + eps)).sum(dim=-1)
    hy = -(py * torch.log2(py + eps)).sum(dim=-1)
    pxy = px[..., :, None] * py[..., None, :]
    hxy1 = -(p * torch.log2(pxy + eps)).sum(dim=(-2, -1))
    hxy2 = -(pxy * torch.log2(pxy + eps)).sum(dim=(-2, -1))
    infomeas1 = (ent - hxy1) / torch.clamp(torch.maximum(hx, hy), min=eps)
    infomeas2 = torch.sqrt(
        torch.clamp(1.0 - torch.exp(-2.0 * float(np.log(2.0)) * (hxy2 - ent)), min=0.0)
    )
    return {
        "AngularSecondMoment": asm,
        "Contrast": contrast,
        "Correlation": correlation,
        "Variance": variance,
        "InverseDifferenceMoment": idm,
        "SumAverage": sum_avg,
        "SumVariance": sum_var,
        "SumEntropy": sum_ent,
        "Entropy": ent,
        "DifferenceVariance": diff_var,
        "DifferenceEntropy": diff_ent,
        "InfoMeas1": infomeas1,
        "InfoMeas2": infomeas2,
    }
