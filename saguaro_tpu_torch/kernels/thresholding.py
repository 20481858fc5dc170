"""CP 4.2.8 threshold-module semantics for secondary-object identification
(port of ``saguaro_tpu/kernels/thresholding.py``).

Global threshold by two-class Otsu (256 bins, the argmax bin centre),
three-class Otsu (128 bins) or Minimum Cross-Entropy (Li), with an optional
log transform, a correction factor and lower/upper bounds. The histogram is
the fused per-label count (K1 on CUDA) with the bins as the "labels".
Adaptive scope runs the same method per block of a grid and clips the
block-constant map around the global guide; ``smooth_for_binarize`` is
CP's edge-corrected Gaussian blur applied before binarising.

Every function takes a leading site-batch dimension: images (B, H, W),
thresholds (B,) or maps (B, H, W).
"""

from __future__ import annotations

import numpy as np
import torch

from saguaro_tpu_torch.kernels.onehot_reduce import mxu_take, onehot_counts
from saguaro_tpu_torch.utils import timing

__all__ = ["global_threshold", "adaptive_threshold", "smooth_for_binarize"]

_BIG = 3.4e38


def _hist(data: torch.Tensor, valid: torch.Tensor, nbins: int):
    """Per-site histogram over [min, max] of the valid data: (B, H, W) ->
    (counts (B, nbins) f32, centers (B, nbins) f32)."""
    b = data.shape[0]
    flat = data.reshape(b, -1)
    vflat = valid.reshape(b, -1)
    big = torch.tensor(_BIG, dtype=torch.float32, device=data.device)
    lo = torch.where(vflat, flat, big).amin(dim=1)
    hi = torch.where(vflat, flat, -big).amax(dim=1)
    span = torch.clamp(hi - lo, min=1e-12)
    q = torch.clamp((flat - lo[:, None]) / span[:, None] * nbins, 0, nbins - 1).to(torch.int32)
    (hist,) = onehot_counts(q, [(torch.zeros_like(q), vflat, 1)], nbins, label_valid=vflat)
    ar = torch.arange(nbins, dtype=torch.float32, device=data.device)
    centers = (ar + 0.5)[None, :] / nbins * span[:, None] + lo[:, None]
    return hist[..., 0], centers


def _otsu_from_hist(hist: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """skimage threshold_otsu on (B, nbins) histograms: maximise
    w0*w1*(mu0-mu1)^2 over split points, return the argmax bin centre
    (the split bin belongs to the lower class)."""
    c1 = torch.cumsum(hist, dim=1)
    m1 = torch.cumsum(hist * centers, dim=1)
    tot_w = c1[:, -1:]
    tot_m = m1[:, -1:]
    w0, w1 = c1, tot_w - c1
    mu0 = m1 / torch.clamp(w0, min=1e-12)
    mu1 = (tot_m - m1) / torch.clamp(w1, min=1e-12)
    var_b = w0 * w1 * (mu0 - mu1) ** 2
    var_b[:, -1] = -1.0  # the last bin cannot be a split
    k = torch.argmax(var_b, dim=1)
    return centers.gather(1, k[:, None])[:, 0]


def _multiotsu3_from_hist(hist: torch.Tensor, centers: torch.Tensor):
    """skimage threshold_multiotsu(classes=3) on (B, nbins) histograms:
    maximise sum_k w_k * mu_k^2 over the two split points; returns the two
    dividing bin centres (each split bin belongs to the lower class)."""
    b, nbins = hist.shape
    dev = hist.device
    p = hist / torch.clamp(hist.sum(dim=1, keepdim=True), min=1.0)
    zeros = torch.zeros((b, 1), dtype=torch.float32, device=dev)
    cw = torch.cat([zeros, torch.cumsum(p, dim=1)], dim=1)
    cm = torch.cat([zeros, torch.cumsum(p * centers, dim=1)], dim=1)

    def seg_score(lo, hi):  # classes are bins [lo, hi); lo/hi (nb, nb) ints
        w = cw[:, hi] - cw[:, lo]
        m = cm[:, hi] - cm[:, lo]
        return torch.where(w > 0, m * m / torch.clamp(w, min=1e-30), torch.zeros_like(w))

    ii = torch.arange(nbins, device=dev)[:, None].expand(nbins, nbins)
    jj = torch.arange(nbins, device=dev)[None, :].expand(nbins, nbins)
    s = (
        seg_score(torch.zeros_like(ii), ii + 1)
        + seg_score(ii + 1, jj + 1)
        + seg_score(jj + 1, torch.full_like(jj, nbins))
    )
    valid = (ii < jj) & (jj < nbins - 1)
    s = torch.where(valid, s, torch.full_like(s, -1.0))
    flat = torch.argmax(s.reshape(b, -1), dim=1)
    i, j = flat // nbins, flat % nbins
    return centers.gather(1, i[:, None])[:, 0], centers.gather(1, j[:, None])[:, 0]


def _li_threshold(data: torch.Tensor, valid: torch.Tensor, tolerance) -> torch.Tensor:
    """skimage threshold_li (CP's Minimum Cross-Entropy) per site: iterate
    t <- (mean_back - mean_fore)/(ln mean_back - ln mean_fore) on the
    min-shifted image from the mean, until |t_next - t| <= tolerance or 256
    iterations (the reference's while_loop, run per site: sites that have
    converged keep their value)."""
    b = data.shape[0]
    flat = data.reshape(b, -1)
    vflat = valid.reshape(b, -1)
    validf = vflat.float()
    big = torch.tensor(_BIG, dtype=torch.float32, device=data.device)
    vmin = torch.where(vflat, flat, big).amin(dim=1)
    # the reference's (data - vmin) * valid, with non-finite pixels zeroed
    # (XLA evaluates a product with a converted mask as a select)
    img = torch.where(vflat, flat - vmin[:, None], torch.zeros_like(flat))
    n = torch.clamp(validf.sum(dim=1), min=1.0)
    tol = torch.as_tensor(tolerance, dtype=torch.float32, device=data.device)
    t_next = (img * validf).sum(dim=1) / n
    t_curr = t_next - 2 * tol - 1.0
    it = 0
    while True:
        running = (torch.abs(t_next - t_curr) > tol) & (it < 256)
        if not timing.flag(running, "li_threshold"):
            break
        timing.count("rounds/li_threshold")
        t = t_next
        fore = (img > t[:, None]) & vflat
        foref = fore.float()
        n_fore = foref.sum(dim=1)
        n_back = torch.clamp(n - n_fore, min=1e-12)
        mean_fore = (img * foref).sum(dim=1) / torch.clamp(n_fore, min=1e-12)
        mean_back = (img * (validf - foref)).sum(dim=1) / n_back
        mean_back = torch.where(mean_back == 0, tol.expand_as(mean_back), mean_back)
        t_new = (mean_back - mean_fore) / (torch.log(mean_back) - torch.log(mean_fore))
        t_curr = torch.where(running, t, t_curr)
        t_next = torch.where(running, t_new, t_next)
        it += 1
    return t_next + vmin


def global_threshold(
    image: torch.Tensor,
    method: str = "otsu",
    log_transform: bool = False,
    middle_foreground: bool = True,
    correction: float = 1.0,
    lower_bound: float = 0.0,
    upper_bound: float = 3.0e38,
    li_tolerance: float = 0.5,
    nbins: int = 256,
):
    """CP 4.2.8 Threshold.get_global_threshold + bounds/correction per site.

    image (B, H, W). method: 'otsu' (two-class, ``nbins`` bins) | 'otsu3'
    (three-class, 128 bins; ``middle_foreground`` picks the lower split) |
    'li'. ``log_transform`` thresholds log1p(values) and maps back with
    expm1. Returns (final (B,), orig (B,)) with
    final = clip(orig * correction, lower, upper).
    """
    data = image.float()
    valid = torch.isfinite(data)
    if log_transform:
        data = torch.log1p(torch.clamp(data, min=0.0))
    if method == "otsu":
        hist, centers = _hist(data, valid, nbins)
        thr = _otsu_from_hist(hist, centers)
    elif method == "otsu3":
        hist, centers = _hist(data, valid, 128)
        t_lo, t_hi = _multiotsu3_from_hist(hist, centers)
        thr = t_lo if middle_foreground else t_hi
    elif method == "li":
        tol = li_tolerance
        if log_transform:
            # the half-grid tolerance lives in log space too
            tol = torch.log1p(torch.tensor(li_tolerance, dtype=torch.float32)) * 0.5 + 1e-6
        thr = _li_threshold(data, valid, tol)
    else:
        raise ValueError(f"unknown threshold method {method!r}")
    if log_transform:
        thr = torch.expm1(thr)
    final = torch.clamp(thr * correction, lower_bound, upper_bound)
    return final, thr


def _block_bounds(n: int, nblocks: int) -> list[int]:
    """CP block boundaries: int(i * n / nblocks) for i in 0..nblocks."""
    inc = n / nblocks
    return [int(i * inc) for i in range(nblocks)] + [n]


def adaptive_threshold(
    image: torch.Tensor,
    method: str = "otsu",
    window_size: int = 50,
    log_transform: bool = False,
    middle_foreground: bool = True,
    correction: float = 1.0,
    lower_bound: float = 0.0,
    upper_bound: float = 3.0e38,
    li_tolerance: float = 0.5,
    nbins: int = 256,
):
    """CP 4.2.8 Threshold module, adaptive scope, per site of (B, H, W).

    The image splits into ``size // window_size`` blocks per axis
    (int-truncated float boundaries; fewer than 2 on an axis is refused);
    the method runs per block as the global scope runs on the whole image
    and fills its block of the map (a constant block takes its value, an
    empty one the global guide); the corrected map is clipped to [0.7, 1.5]
    x the corrected guide, then to [lower_bound, upper_bound]. Returns
    (final_map (B, H, W), guide_final (B,), orig_map (B, H, W))."""
    b, h, w = image.shape
    dev = image.device
    nb_i, nb_j = h // window_size, w // window_size
    if nb_i < 2 or nb_j < 2:
        raise ValueError(
            f"Adaptive window {window_size} cannot exceed 50% of an image dimension"
            f" (image {h}x{w})"
        )
    bounds_i = _block_bounds(h, nb_i)
    bounds_j = _block_bounds(w, nb_j)
    nb = nb_i * nb_j
    _, guide_orig = global_threshold(
        image, method=method, log_transform=log_transform, middle_foreground=middle_foreground,
        li_tolerance=li_tolerance, nbins=nbins,
    )
    data = image.float()
    valid = torch.isfinite(data)
    if log_transform:
        data = torch.log1p(torch.clamp(data, min=0.0))
    row_blk = np.searchsorted(np.asarray(bounds_i[1:-1]), np.arange(h), "right")
    col_blk = np.searchsorted(np.asarray(bounds_j[1:-1]), np.arange(w), "right")
    block_id = torch.as_tensor(row_blk[:, None] * nb_j + col_blk[None, :], device=dev)
    bid = block_id.reshape(1, -1).expand(b, h * w)
    dflat, vflat = data.reshape(b, -1), valid.reshape(b, -1)
    n_valid = torch.zeros((b, nb), dtype=torch.float32, device=dev).scatter_add_(
        1, bid, vflat.float())

    if method in ("otsu", "otsu3"):
        blk_bins = nbins if method == "otsu" else 128
        big = torch.tensor(_BIG, dtype=torch.float32, device=dev)
        vmin = torch.full((b, nb), _BIG, device=dev).scatter_reduce_(
            1, bid, torch.where(vflat, dflat, big), "amin")
        vmax = torch.full((b, nb), -_BIG, device=dev).scatter_reduce_(
            1, bid, torch.where(vflat, dflat, -big), "amax")
        span = torch.clamp(vmax - vmin, min=1e-12)
        bid32 = bid.to(torch.int32)
        per_px = mxu_take(torch.stack([vmin, span], dim=2), bid32, nb)
        q = torch.clamp((dflat - per_px[..., 0]) / per_px[..., 1] * blk_bins, 0, blk_bins - 1)
        (hist,) = onehot_counts(bid32, [(q.to(torch.int32), vflat, blk_bins)], nb, label_valid=vflat)
        ar = torch.arange(blk_bins, dtype=torch.float32, device=dev)
        centers = (ar[None, None, :] + 0.5) / blk_bins * span[..., None] + vmin[..., None]
        hist2, centers2 = hist.reshape(b * nb, blk_bins), centers.reshape(b * nb, blk_bins)
        if method == "otsu":
            thr_blocks = _otsu_from_hist(hist2, centers2)
        else:
            t_lo, t_hi = _multiotsu3_from_hist(hist2, centers2)
            thr_blocks = t_lo if middle_foreground else t_hi
        thr_blocks = torch.where(vmax - vmin <= 0, vmin, thr_blocks.reshape(b, nb))
    elif method == "li":
        tol = li_tolerance
        if log_transform:
            tol = torch.log1p(torch.tensor(li_tolerance, dtype=torch.float32)) * 0.5 + 1e-6
        # blocks zero-padded to a common shape, every block iterated at once
        bh = max(hi - lo for lo, hi in zip(bounds_i, bounds_i[1:]))
        bw = max(hi - lo for lo, hi in zip(bounds_j, bounds_j[1:]))
        blocks, bvalid = [], []
        for i in range(nb_i):
            i0, i1 = bounds_i[i], bounds_i[i + 1]
            for j in range(nb_j):
                j0, j1 = bounds_j[j], bounds_j[j + 1]
                pad = (0, bw - (j1 - j0), 0, bh - (i1 - i0))
                blocks.append(torch.nn.functional.pad(data[:, i0:i1, j0:j1], pad))
                bvalid.append(torch.nn.functional.pad(valid[:, i0:i1, j0:j1], pad, value=False))
        blocks = torch.stack(blocks, dim=1).reshape(b * nb, bh, bw)
        bvalid = torch.stack(bvalid, dim=1).reshape(b * nb, bh, bw)
        thr_blocks = _li_threshold(blocks, bvalid, tol).reshape(b, nb)
    else:
        raise ValueError(f"unknown threshold method {method!r}")

    guide_t = torch.log1p(torch.clamp(guide_orig, min=0.0)) if log_transform else guide_orig
    thr_blocks = torch.where(n_valid > 0, thr_blocks, guide_t[:, None])
    if log_transform:
        thr_blocks = torch.expm1(thr_blocks)
    orig_map = thr_blocks[:, block_id]
    guide_corr = (guide_orig * correction)[:, None, None]
    bounded = torch.clamp(orig_map * correction, 0.7 * guide_corr, 1.5 * guide_corr)
    final_map = torch.clamp(bounded, lower_bound, upper_bound)
    guide_final = torch.clamp(guide_corr[:, 0, 0], lower_bound, upper_bound)
    return final_map, guide_final, orig_map


def smooth_for_binarize(image: torch.Tensor, sigma: float, truncate: float = 4.0) -> torch.Tensor:
    """CP Threshold.apply_threshold smoothing of (B, H, W): a Gaussian blur
    with zero fill normalized by the blurred all-ones mask (edge-corrected),
    separable, taps within ``truncate * sigma`` (radius at most 32)."""
    b, h, w = image.shape
    radius = 32
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=image.device)
    s = torch.clamp(torch.tensor(sigma, dtype=torch.float32, device=image.device), min=1e-6)
    k = torch.exp(-0.5 * (x / s) ** 2)
    k = torch.where(x.abs() <= truncate * s + 0.5, k, torch.zeros_like(k))
    k = k / k.sum()

    def blur1d(a, dim):
        n = a.shape[dim]
        pad = (0, 0, radius, radius) if dim == 1 else (radius, radius)
        ap = torch.nn.functional.pad(a, pad)
        out = torch.zeros_like(a)
        for i in range(2 * radius + 1):
            out = out + k[i] * ap.narrow(dim, i, n)
        return out

    num = blur1d(blur1d(image.float(), 1), 2)
    den = blur1d(blur1d(torch.ones_like(image, dtype=torch.float32), 1), 2)
    return num / torch.clamp(den, min=1e-12)
