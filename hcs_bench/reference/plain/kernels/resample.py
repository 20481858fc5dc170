# Frozen copy of saguaro_tpu_torch/kernels/resample.py (the port's plain forms), part of the
# benchmark's reference: CUDA dispatch removed, imports made local. Not edited
# when the program changes.
"""The plain forms of the port's ``kernels/resample.py`` that the measurement
and the embedding call, and the helpers they use."""

from __future__ import annotations
from functools import lru_cache
import numpy as np


_LANCZOS_A = 3.0


_BICUBIC_A = -0.5  # PIL/Keys cubic coefficient


_BICUBIC_SUPPORT = 2.0


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
