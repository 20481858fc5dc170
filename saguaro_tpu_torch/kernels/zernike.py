"""Zernike shape-moment tables — CP AreaShape_Zernike_n_m (n <= 9, 30
features). The moments themselves ride the measurement's pass C
(``kernels/fused_measure``); this module holds the index order and the
radial-polynomial coefficients they use.
"""

from __future__ import annotations

from functools import lru_cache
from math import factorial

import numpy as np

__all__ = ["ZERNIKE_INDEXES"]

ZERNIKE_INDEXES: tuple[tuple[int, int], ...] = tuple(
    (n, m) for n in range(10) for m in range(n % 2, n + 1, 2)
)


@lru_cache(maxsize=1)
def _radial_coeffs() -> np.ndarray:
    """(len(ZERNIKE_INDEXES), 10) coefficients of rho^k for each R_nm."""
    coeffs = np.zeros((len(ZERNIKE_INDEXES), 10), np.float64)
    for i, (n, m) in enumerate(ZERNIKE_INDEXES):
        for s in range((n - m) // 2 + 1):
            c = (
                (-1) ** s
                * factorial(n - s)
                / (factorial(s) * factorial((n + m) // 2 - s) * factorial((n - m) // 2 - s))
            )
            coeffs[i, n - 2 * s] = c
    coeffs.setflags(write=False)
    return coeffs
