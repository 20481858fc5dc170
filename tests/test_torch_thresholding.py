"""Global threshold: the port (K1 histogram's plain form on the CPU)
against the reference, per site of a batch. Two- and three-class Otsu are
equal (exact counts, the same bin-centre arithmetic). Li iterates on
ratios of f32 sums over every pixel, summed in another order than XLA's,
so its threshold agrees to 2e-6 relative (a few ulps); with the default
half-grid tolerance it lands on the same value."""

import numpy as np
import pytest
import torch

from saguaro_tpu.kernels.thresholding import global_threshold as ref_threshold
from saguaro_tpu_torch.kernels.thresholding import global_threshold

from .torch_data import blob_sites


@pytest.fixture(scope="module")
def bodies():
    img, _ = blob_sites(n_sites=3, h=48, w=52, n_ch=3, seed=9)
    body = img[..., 1:].mean(axis=-1)
    body[2, :4, :4] = np.nan  # non-finite pixels are excluded
    return body


@pytest.mark.parametrize(
    "method,log,middle,tol",
    [
        ("otsu", False, True, 0.5),
        ("otsu", True, True, 0.5),
        ("otsu3", False, True, 0.5),
        ("otsu3", False, False, 0.5),
        ("li", False, True, 0.5),
        ("li", True, True, 1e-4),
    ],
)
def test_global_threshold_equal(bodies, method, log, middle, tol):
    kw = dict(method=method, log_transform=log, middle_foreground=middle,
              correction=0.9, lower_bound=100.0, li_tolerance=tol)
    final, orig = global_threshold(torch.from_numpy(bodies), **kw)
    for s in range(len(bodies)):
        f_ref, o_ref = ref_threshold(bodies[s], **kw)
        rtol = 2e-6 if method == "li" else 0.0
        np.testing.assert_allclose(final[s].item(), float(f_ref), rtol=rtol, atol=0)
        np.testing.assert_allclose(orig[s].item(), float(o_ref), rtol=rtol, atol=0)


def test_unknown_method_raises(bodies):
    with pytest.raises(ValueError, match="unknown threshold"):
        global_threshold(torch.from_numpy(bodies), method="triangle")
