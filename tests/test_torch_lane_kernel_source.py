"""What the K4 pass C and E kernels (``csrc/lane_sums.cu``) assume, checked
on the CPU without a card or a compiler: the Zernike (n, m) table whose
non-zero radial terms the kernel evaluates equals the non-zero pattern of
``_radial_coeffs()`` in both packages (the kernel reads the coefficient
values there from the ``zcoef`` input), and the kernel's channel limit and
term count match the wrapper's. That every lane lands in its place is held
on the card (``tests/test_torch_kernels_cuda.py``)."""

import re
from pathlib import Path

import numpy as np
import pytest

from saguaro_tpu.kernels import zernike as ref_zernike
from saguaro_tpu_torch.kernels import segment_cuda as sc
from saguaro_tpu_torch.kernels import zernike

from .torch_data import share_cpu_threads

share_cpu_threads()

SOURCE = (Path(sc.__file__).resolve().parents[1] / "csrc" / "lane_sums.cu").read_text()


def _define(name: str) -> str:
    m = re.search(rf"^#define {name} (.+?)(?:\s*//.*)?$", SOURCE, re.M)
    assert m, name
    return m.group(1)


def _zernike_nm() -> list[tuple[int, int]]:
    ns = [int(v) for v in _define("SAG_ZERNIKE_N").split(",")]
    ms = [int(v) for v in _define("SAG_ZERNIKE_M").split(",")]
    return list(zip(ns, ms))


@pytest.mark.parametrize("coeffs", [zernike._radial_coeffs, ref_zernike._radial_coeffs],
                         ids=["port", "reference"])
def test_kernel_zernike_terms_are_the_non_zero_coefficients(coeffs):
    nm = _zernike_nm()
    assert tuple(nm) == zernike.ZERNIKE_INDEXES == tuple(ref_zernike.ZERNIKE_INDEXES)
    pattern = np.zeros((len(nm), 10), bool)
    for j, (n, m) in enumerate(nm):
        pattern[j, m : n + 1 : 2] = True
    c = coeffs()
    np.testing.assert_array_equal(c != 0, pattern)
    assert int(pattern.sum()) == 70
    # the values the kernel reads at those places are the reference's, exactly
    np.testing.assert_array_equal(zernike._radial_coeffs(), ref_zernike._radial_coeffs())


def test_kernel_constants_match_the_wrapper():
    assert int(_define("SAG_MAX_CH")) == sc._MAX_CH
    assert int(_define("SAG_ZERNIKE_TERMS")) == int((zernike._radial_coeffs() != 0).sum())
