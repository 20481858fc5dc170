"""Lanczos re-binning: PIL-parity separable resample.

Port of ``saguaro_tpu.kernels.resample``. The reference behaviour is PIL's
``img.resize((R, R), resample=LANCZOS)`` on every screening image. Each
axis is a resampling matrix built exactly as PIL's ``precompute_coeffs``
does (support scaled for downsampling, half-pixel centres, per-row
normalisation), so ``out = Ry @ img @ Rx^T``.

A CUDA tensor goes to K7 (``kernels/resample_cuda``, ``csrc/lanczos.cu``),
which sums only the tap windows of bands of 4 outputs (``axis_bands``). A
CPU tensor takes the plain form, ``resize_plain``: the reference's dense
two-matmul XLA contract in f32 with TF32 off. Integer dtypes then get
PIL's round-half-up and clip.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from saguaro_tpu_torch.device import full_f32
from saguaro_tpu_torch.kernels import resample_cuda

__all__ = [
    "axis_windows",
    "axis_bands",
    "lanczos_matrices",
    "lanczos_resample",
    "lanczos_resize",
    "lanczos_resize_batch",
    "bicubic_axis_matrix",
    "resize_plain",
]

_LANCZOS_A = 3.0
_BICUBIC_A = -0.5  # PIL/Keys cubic coefficient
_BICUBIC_SUPPORT = 2.0
# dtypes K7 reads in place; others are widened to f32 first
_KERNEL_DTYPES = (torch.uint8, torch.uint16, torch.float32)


def _lanczos_filter(x: np.ndarray) -> np.ndarray:
    """Lanczos-3 windowed sinc, sinc(x)*sinc(x/3) on |x|<3."""
    x = np.asarray(x, dtype=np.float64)
    out = np.sinc(x) * np.sinc(x / _LANCZOS_A)
    return np.where(np.abs(x) < _LANCZOS_A, out, 0.0)


def _bicubic_filter(x: np.ndarray) -> np.ndarray:
    """PIL's bicubic (Keys a=-0.5) kernel on |x|<2."""
    x = np.abs(np.asarray(x, dtype=np.float64))
    a = _BICUBIC_A
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0
    far = (((x - 5.0) * x + 8.0) * x - 4.0) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


_FILTERS = {
    "lanczos": (_lanczos_filter, _LANCZOS_A),
    "bicubic": (_bicubic_filter, _BICUBIC_SUPPORT),
}


@lru_cache(maxsize=64)
def _axis_matrix(in_size: int, out_size: int, filt: str = "lanczos") -> np.ndarray:
    """(out_size, in_size) resampling matrix for one axis, PIL-equivalent."""
    filter_fn, base_support = _FILTERS[filt]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = base_support * filterscale
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        # PIL: xmin = (int)(center - support + 0.5), xmax likewise —
        # a half-open rounded window, not floor/ceil.
        xmin = max(int(np.floor(center - support + 0.5)), 0)
        xmax = min(int(np.floor(center + support + 0.5)), in_size)
        xs = np.arange(xmin, xmax)
        w = filter_fn((xs - center + 0.5) / filterscale)
        wsum = w.sum()
        if wsum != 0:
            w = w / wsum
        mat[xx, xmin:xmax] = w
    return mat


def bicubic_axis_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) f32 PIL-bicubic resampling matrix (the embed
    preprocessing's resize)."""
    return _axis_matrix(in_size, out_size, "bicubic").astype(np.float32)


def lanczos_matrices(in_shape: tuple[int, int], out_shape: tuple[int, int]):
    """Return (Ry, Rx) float32 weight matrices for a 2-D resize."""
    ry = _axis_matrix(in_shape[0], out_shape[0]).astype(np.float32)
    rx = _axis_matrix(in_shape[1], out_shape[1]).astype(np.float32)
    return ry, rx


@lru_cache(maxsize=64)
def axis_windows(in_size: int, out_size: int):
    """One axis of ``lanczos_matrices`` as PIL's coefficient table: per
    output o, the first input ``start[o]``, the tap count ``n[o]`` and the
    f32 weights ``w[o, :n[o]]`` (zero beyond), so that ``R[o, start[o] + k]
    = w[o, k]`` and every other entry of row o is 0. Border windows are the
    matrix's own clipped, renormalised rows."""
    mat = _axis_matrix(in_size, out_size).astype(np.float32)
    nz = mat != 0
    has = nz.any(axis=1)
    start = np.where(has, nz.argmax(axis=1), 0).astype(np.int32)
    stop = np.where(has, in_size - nz[:, ::-1].argmax(axis=1), 0).astype(np.int32)
    n = (stop - start).astype(np.int32)
    taps = max(int(n.max()), 1)
    w = np.zeros((out_size, taps), np.float32)
    for o in range(out_size):
        w[o, : n[o]] = mat[o, start[o] : stop[o]]
    return start, n, w


@lru_cache(maxsize=8)
def _device_matrices(in_shape, out_shape, device: torch.device, dtype: torch.dtype):
    return tuple(torch.as_tensor(m, device=device, dtype=dtype)
                 for m in lanczos_matrices(in_shape, out_shape))


def resize_plain(imgs: torch.Tensor, out_shape: tuple[int, int], magnitude: bool = False,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch form of K7: (B, H, W) -> (B, h, w) ``Ry @ x @ Rx^T`` as
    two dense matmuls in ``dtype`` (f32 with TF32 off by default), before
    any rounding. ``magnitude=True`` uses |Ry|, |Rx| and |x|: the scale
    (per output, sum of |w * x|) against which two summation orders are
    compared."""
    ry, rx = _device_matrices(tuple(imgs.shape[1:]), tuple(out_shape), imgs.device, dtype)
    x = imgs.to(dtype)
    if magnitude:
        ry, rx, x = ry.abs(), rx.abs(), x.abs()
    with full_f32():
        return torch.matmul(torch.matmul(ry, x), rx.T)


def _cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if not dtype.is_floating_point:
        info = torch.iinfo(dtype)
        # PIL rounds half away from zero then clips to the dtype range.
        x = torch.clamp(torch.floor(x + 0.5), info.min, info.max)
    return x.to(dtype)


@lru_cache(maxsize=64)
def axis_bands(in_size: int, out_size: int):
    """``axis_windows`` cut into bands of 4 neighbouring outputs, as K7
    reads them: per band g (outputs 4g .. 4g+3) its first input ``base``
    and ``span``, the union of its outputs' tap windows, in ``meta`` (G, 2)
    int32, and the dense weights ``w`` (G, span_max, 4) f32 with ``w[g, t,
    r] = R[4g + r, base + t]``: zero beyond an output's window and for the
    missing outputs of a last, partial band."""
    start, n, w = axis_windows(in_size, out_size)
    n_bands = -(-out_size // 4)
    meta = np.zeros((n_bands, 2), np.int32)
    for g in range(n_bands):
        outs = [o for o in range(4 * g, min(4 * g + 4, out_size)) if n[o] > 0]
        if outs:
            lo = min(int(start[o]) for o in outs)
            meta[g] = lo, max(int(start[o] + n[o]) for o in outs) - lo
    bands = np.zeros((n_bands, max(int(meta[:, 1].max()), 1), 4), np.float32)
    for o in range(out_size):
        g, r = divmod(o, 4)
        t0 = int(start[o]) - int(meta[g, 0])
        bands[g, t0 : t0 + n[o], r] = w[o, : n[o]]
    return meta, bands


@lru_cache(maxsize=32)
def _device_bands(in_size: int, out_size: int, device: torch.device):
    """``axis_bands`` on ``device``, built once per (in, out, device)."""
    return tuple(torch.as_tensor(a, device=device) for a in axis_bands(in_size, out_size))


@lru_cache(maxsize=32)
def _card_plan(in_h, in_w, out_h, out_w, batch, dtype, device):
    """K7's plan for this shape on ``device``, made once."""
    return resample_cuda.lanczos_card_plan(
        axis_bands(in_h, out_h)[0], axis_bands(in_w, out_w)[0], batch, dtype, device
    )


def lanczos_resample(imgs: torch.Tensor, out_shape: tuple[int, int]) -> torch.Tensor:
    """(B, H, W) -> (B, h, w) f32 before rounding: K7 on a CUDA tensor
    (uint8, uint16 and f32 are read in place, other dtypes are widened to
    f32 first), ``resize_plain`` on a CPU tensor."""
    out_shape = (int(out_shape[0]), int(out_shape[1]))
    if not imgs.is_cuda:
        return resize_plain(imgs, out_shape)
    x = imgs if imgs.dtype in _KERNEL_DTYPES else imgs.float()
    b, in_h, in_w = x.shape
    (h, w), dev = out_shape, x.device
    plan = _card_plan(in_h, in_w, h, w, b, x.dtype, dev)
    return resample_cuda.lanczos_resize_cuda(
        x.contiguous(), _device_bands(in_h, h, dev), _device_bands(in_w, w, dev), plan, out_shape
    )


def lanczos_resize_batch(imgs, out_shape: tuple[int, int], dtype: torch.dtype | None = None):
    """Resize a (B, H, W) batch; integer dtypes get PIL-style round+clip.
    K7 on a CUDA tensor, the plain form on a CPU tensor."""
    imgs = torch.as_tensor(imgs)
    return _cast(lanczos_resample(imgs, out_shape), dtype or imgs.dtype)


def lanczos_resize(img, out_shape: tuple[int, int], dtype: torch.dtype | None = None):
    """Resize one (H, W) image; integer dtypes get PIL-style round+clip."""
    return lanczos_resize_batch(torch.as_tensor(img)[None], out_shape, dtype)[0]
