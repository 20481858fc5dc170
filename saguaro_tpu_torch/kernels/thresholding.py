"""CP 4.2.8 threshold-module semantics for secondary-object identification
(port of ``saguaro_tpu/kernels/thresholding.py``, global scope).

Global threshold by two-class Otsu (256 bins, the argmax bin centre),
three-class Otsu (128 bins) or Minimum Cross-Entropy (Li), with an optional
log transform, a correction factor and lower/upper bounds. The histogram is
the fused per-label count (K1 on CUDA) with the bins as the "labels".
Adaptive scope and smoothing at binarisation come in a later slice.

Every function takes a leading site-batch dimension: images (B, H, W),
thresholds (B,).
"""

from __future__ import annotations

import torch

from saguaro_tpu_torch.kernels.onehot_reduce import onehot_counts

__all__ = ["global_threshold"]

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
    (hist,) = onehot_counts(q, [(torch.zeros_like(q), vflat, 1)], nbins)
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
        if not bool(running.any()):
            break
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
