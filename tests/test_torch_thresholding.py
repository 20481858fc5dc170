"""Global and adaptive threshold and smoothing at binarisation: the port
(K1 histogram's plain form on the CPU) against the reference, per site of
a batch. Two- and three-class Otsu are
equal (exact counts, the same bin-centre arithmetic). Li iterates on
ratios of f32 sums over every pixel, summed in another order than XLA's,
so its threshold agrees to 2e-6 relative (a few ulps); with the default
half-grid tolerance it lands on the same value. Adaptive scope runs the
same methods per block: Otsu maps are equal, Li maps and maps mapped
back from log space (expm1 of each library differs by an ulp) within 2e-6
relative. The smoothing blur sums its 65 taps in another order: 1e-5
relative."""

import numpy as np
import pytest
import torch

from saguaro_tpu.kernels import thresholding as ref
from saguaro_tpu.kernels.thresholding import global_threshold as ref_threshold
from saguaro_tpu_torch.kernels.thresholding import (
    adaptive_threshold,
    global_threshold,
    smooth_for_binarize,
)

from .torch_data import blob_sites, share_cpu_threads

share_cpu_threads()


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


@pytest.mark.parametrize(
    "method,log,middle,window",
    [("otsu", False, True, 16), ("otsu", True, True, 20), ("otsu3", False, False, 16),
     ("li", False, True, 20)],
)
def test_adaptive_threshold(bodies, method, log, middle, window):
    kw = dict(method=method, log_transform=log, middle_foreground=middle, window_size=window,
              correction=1.1, lower_bound=50.0, li_tolerance=0.5)
    final, guide, orig = adaptive_threshold(torch.from_numpy(bodies), **kw)
    rtol = 2e-6 if method == "li" or log else 0.0
    for s in range(len(bodies)):
        f_ref, g_ref, o_ref = ref.adaptive_threshold(bodies[s], **kw)
        np.testing.assert_allclose(final[s].numpy(), np.asarray(f_ref), rtol=rtol, atol=0)
        np.testing.assert_allclose(orig[s].numpy(), np.asarray(o_ref), rtol=rtol, atol=0)
        np.testing.assert_allclose(guide[s].item(), float(g_ref), rtol=rtol, atol=0)


def test_adaptive_window_too_large_raises(bodies):
    with pytest.raises(ValueError, match="Adaptive window"):
        adaptive_threshold(torch.from_numpy(bodies), window_size=30)


@pytest.mark.parametrize("sigma", [0.5, 1.48, 6.0])
def test_smooth_for_binarize(bodies, sigma):
    clean = np.nan_to_num(bodies, nan=0.0)
    got = smooth_for_binarize(torch.from_numpy(clean), sigma).numpy()
    for s in range(len(clean)):
        want = np.asarray(ref.smooth_for_binarize(clean[s], sigma))
        np.testing.assert_allclose(got[s], want, rtol=1e-5, atol=0)
