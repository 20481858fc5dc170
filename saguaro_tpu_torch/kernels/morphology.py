"""Label morphology: secondary/tertiary objects + granularity spectrum
(port of ``saguaro_tpu/kernels/morphology.py``).

* ``propagate_labels``: CP IdentifySecondaryObjects 'propagation' as a
  Bellman-Ford label race under CP's step cost
  sqrt((dI^2 + lambda*d^2) / (1 + lambda)); ``expand_labels``: plain
  dilation growth (the 'distance' flavour).
* ``tertiary_objects``: IdentifyTertiaryObjects (Cytoplasm = Cells minus
  Nuclei).
* ``granularity_spectrum_cp``: CP 4.2.8 MeasureGranularity.

Every function takes a leading batch dimension: labels and images are
(B, H, W). The reference's ``lax.while_loop``s are Python loops that check
convergence on the device every ``check_every`` sweeps.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "expand_labels",
    "propagate_labels",
    "tertiary_objects",
    "granularity_spectrum_cp",
]


def _shift(a: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """out[..., i, j] = a[..., i - dy, j - dx], ``fill`` outside — the
    reference's ``roll(pad(a, 1), (dy, dx))[1:-1, 1:-1]`` for |dy|, |dx| <= 1."""
    h, w = a.shape[-2:]
    p = F.pad(a, (1, 1, 1, 1), value=fill)
    return p[..., 1 - dy : 1 - dy + h, 1 - dx : 1 - dx + w]


def expand_labels(
    labels: torch.Tensor,
    intensity: torch.Tensor,
    threshold: torch.Tensor | float = 0.0,
    iterations: int = 12,
) -> torch.Tensor:
    """Grow (B, H, W) seed labels over above-threshold pixels, one
    8-neighbourhood ring per iteration. ``threshold``: scalar or (B,)."""
    thr = torch.as_tensor(threshold, dtype=torch.float32, device=intensity.device)
    if thr.dim() == 1:
        thr = thr[:, None, None]
    claimable = intensity > thr
    lab = labels.to(torch.int32)
    for _ in range(iterations):
        neigh = F.max_pool2d(lab.float()[:, None], 3, stride=1, padding=1)[:, 0].to(torch.int32)
        lab = torch.where((lab == 0) & claimable, neigh, lab)
    return lab


_SHIFTS = [
    (-1, 0, 1.0), (1, 0, 1.0), (0, -1, 1.0), (0, 1, 1.0),
    (-1, -1, 2.0), (-1, 1, 2.0), (1, -1, 2.0), (1, 1, 2.0),
]


def propagate_labels(
    labels: torch.Tensor,
    intensity: torch.Tensor,
    threshold: torch.Tensor | float = 0.0,
    iterations: int | None = None,
    regularization: float = 0.05,
    check_every: int = 8,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """CP IdentifySecondaryObjects 'propagation': a cost-based label race.

    Every claimable pixel ends with the seed label of least accumulated
    path cost, one 8-neighbourhood step costing
    ``sqrt((dI^2 + lambda*d^2) / (1 + lambda))``. ``iterations=None`` (CP
    semantics) relaxes to convergence: blocks of ``check_every`` sweeps
    until a block improves no pixel of any site (relaxation is monotone, so
    that is the global fixpoint; a site that converged earlier is unchanged
    by further sweeps). An integer bounds the propagation radius.

    labels, intensity, mask: (B, H, W); threshold: scalar or (B,).
    """
    dev = intensity.device
    lam = torch.tensor(regularization, dtype=torch.float32, device=dev)
    img = intensity.float()
    if mask is None:
        thr = torch.as_tensor(threshold, dtype=torch.float32, device=dev)
        claimable = img > (thr[:, None, None] if thr.dim() == 1 else thr)
    else:
        claimable = mask
    seeded = labels > 0
    big = torch.tensor(3.4e38, dtype=torch.float32, device=dev)
    dist = torch.where(seeded, torch.zeros_like(img), big)
    lab = labels.to(torch.int32)
    grow = claimable & ~seeded
    # the cost of each of the 8 steps depends only on the image
    costs = []
    for dy, dx, d2 in _SHIFTS:
        d_i = img - _shift(img, dy, dx, 0.0)
        costs.append(torch.sqrt((d_i * d_i + lam * d2) / (1.0 + lam)))

    def step(dist, lab):
        best_dist, best_lab = dist, lab
        for (dy, dx, _), cost in zip(_SHIFTS, costs):
            n_lab = _shift(lab, dy, dx, 0)
            cand = _shift(dist, dy, dx, 3.4e38) + cost
            take = (cand < best_dist) & (n_lab > 0)
            best_dist = torch.where(take, cand, best_dist)
            best_lab = torch.where(take, n_lab, best_lab)
        return torch.where(grow, best_dist, dist), torch.where(grow, best_lab, lab)

    if iterations is not None:
        for _ in range(iterations):
            dist, lab = step(dist, lab)
        return lab
    cap = labels.shape[-2] * labels.shape[-1]
    it = 0
    while it < cap:
        prev = dist
        for _ in range(check_every):
            dist, lab = step(dist, lab)
        it += check_every
        if not bool((dist < prev).any()):
            break
    return lab


def tertiary_objects(cells: torch.Tensor, nuclei: torch.Tensor) -> torch.Tensor:
    """Cytoplasm = cell label where the nucleus doesn't cover it."""
    return torch.where(nuclei > 0, torch.zeros_like(cells), cells).to(torch.int32)


# ----------------------------------------------------------------------------
# CP 4.2.8 MeasureGranularity


def _pool_max(x: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """(B, H, W) max over a (kh, kw) window centred on each pixel, outside
    pixels ignored (``reduce_window(..., 'SAME')`` with a -inf init)."""
    return F.max_pool2d(x[:, None], (kh, kw), stride=1, padding=(kh // 2, kw // 2))[:, 0]


def _grey_disk(x: torch.Tensor, radius: int, op: str) -> torch.Tensor:
    """Grey erosion ('min') / dilation ('max') with
    skimage.morphology.disk(radius): one horizontal window per distinct row
    half-width, combined over vertical shifts; outside pixels are ignored."""
    sign = 1.0 if op == "max" else -1.0
    xs = x * sign
    widths: dict[int, list[int]] = {}
    for dy in range(-radius, radius + 1):
        widths.setdefault(int(math.floor(math.sqrt(radius * radius - dy * dy))), []).append(dy)
    h = xs.shape[-2]
    out = None
    for wx, dys in widths.items():
        horiz = _pool_max(xs, 1, 2 * wx + 1)
        pad = F.pad(horiz, (0, 0, radius, radius), value=-math.inf)
        for dy in dys:
            cand = pad[:, radius - dy : radius - dy + h]
            out = cand if out is None else torch.maximum(out, cand)
    return out * sign


def _cross(x: torch.Tensor, op: str) -> torch.Tensor:
    """3x3 cross (skimage disk(1)) min/max — 5-point stencil."""
    fill = -math.inf if op == "max" else math.inf
    f = torch.maximum if op == "max" else torch.minimum
    out = x
    for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        out = f(out, _shift(x, dy, dx, fill))
    return out


def _reconstruct_cross_unit(seed: torch.Tensor, ceiling: torch.Tensor, check_every: int = 32):
    """Grayscale reconstruction by dilation, disk(1) footprint: blocked unit
    dilations r <- min(dilate(r), ceiling) until a block of ``check_every``
    sweeps changes nothing (the fixpoint is unique)."""
    r = seed
    while True:
        prev = r
        for _ in range(check_every):
            r = torch.minimum(_cross(r, "max"), ceiling)
        if not bool((r > prev).any()):
            return r


def _align_corners_mat(n_out: int, n_in: int) -> np.ndarray:
    """Row-interpolation matrix for map_coordinates(order=1) at
    coords i * (n_in-1)/(n_out-1) — CP's background upsample mapping."""
    a = np.zeros((n_out, n_in), np.float32)
    if n_in == 1:
        a[:, 0] = 1.0
        return a
    src = np.arange(n_out, dtype=np.float64) * (n_in - 1) / max(n_out - 1, 1)
    k0 = np.clip(np.floor(src).astype(int), 0, n_in - 2)
    w = (src - k0).astype(np.float32)
    a[np.arange(n_out), k0] = 1.0 - w
    a[np.arange(n_out), k0 + 1] = w
    return a


def granularity_spectrum_cp(
    image: torch.Tensor,
    spectrum_length: int = 16,
    subsample_size: float = 0.25,
    image_sample_size: float = 0.25,
    element_size: int = 10,
) -> torch.Tensor:
    """CP 4.2.8 MeasureGranularity (module defaults: subsample 0.25,
    background sample 0.25, element radius 10, length 16; whole-image mask)
    for a (B, H, W) batch of planes -> (B, spectrum_length).

    1. subsample by a strided gather (1/subsample is an integer);
    2. background = grey erosion then dilation with disk(element_size) on a
       further subsample, upsampled back with the align-corners mapping and
       subtracted (clipped at 0);
    3. per k: erode with the 3x3 cross, reconstruct under the
       background-removed image to convergence, record
       mean(prev - rec) * 100 / startmean.

    The planes of a batch reconstruct together: the fixpoint is unique, so
    sweeping a plane past its own convergence changes nothing.
    """
    x = image.float()
    h, w = x.shape[-2:]
    stride = int(round(1.0 / subsample_size))
    if abs(stride * subsample_size - 1.0) > 1e-9:
        raise ValueError(
            f"granularity subsample_size={subsample_size} must be a reciprocal integer"
        )
    bstride = int(round(1.0 / image_sample_size))
    if abs(bstride * image_sample_size - 1.0) > 1e-9:
        raise ValueError(
            f"granularity image_sample_size={image_sample_size} must be a reciprocal integer"
        )
    nh, nw = math.ceil(h * subsample_size), math.ceil(w * subsample_size)
    pixels = x[:, : (nh - 1) * stride + 1 : stride, : (nw - 1) * stride + 1 : stride]
    bh, bw = math.ceil(nh * image_sample_size), math.ceil(nw * image_sample_size)
    back = pixels[:, : (bh - 1) * bstride + 1 : bstride, : (bw - 1) * bstride + 1 : bstride]
    back = _grey_disk(back, element_size, "min")
    back = _grey_disk(back, element_size, "max")
    up_r = torch.from_numpy(_align_corners_mat(nh, bh)).to(x.device)
    up_c = torch.from_numpy(_align_corners_mat(nw, bw)).to(x.device)
    back_up = up_r @ back @ up_c.T
    pixels = torch.clamp(pixels - back_up, min=0.0)

    startmean = pixels.mean(dim=(1, 2))
    denom = torch.clamp(startmean, min=float(np.finfo(np.float64).eps))
    ero = pixels
    prev_rec = pixels
    out = []
    for _ in range(spectrum_length):
        ero = _cross(ero, "min")
        rec = _reconstruct_cross_unit(ero, pixels)
        # mean of the pixelwise difference (reconstructions decrease
        # pixelwise), free of the cancellation of two near-equal means
        out.append((prev_rec - rec).mean(dim=(1, 2)) * 100.0 / denom)
        prev_rec = rec
    return torch.stack(out, dim=1)
