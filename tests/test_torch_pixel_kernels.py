"""The port's pixel-stage kernels (max projection, illumination, image QC)
against the JAX package on the same seeded inputs, on the CPU. Tolerances:
projections exact; ``illum_correct`` 1e-6 relative (one f32 division
each); ``estimate_illumination`` 1e-5 relative (f32 plate means and
convolutions summed in another order); the QC slope 1e-4 relative (the FFT
and the ring sums differ in the last bits between XLA and PyTorch, and the
slope is a log-log regression of those sums); PercentMaximal exactly."""

import numpy as np
import pytest
import torch

from saguaro_tpu.kernels.illum import estimate_illumination as ref_estimate
from saguaro_tpu.kernels.illum import illum_correct as ref_correct
from saguaro_tpu.kernels.maxproj import max_project as ref_max_project
from saguaro_tpu.kernels.maxproj import max_project_batch as ref_max_project_batch
from saguaro_tpu.kernels.qc import _radius_labels as ref_radius_labels
from saguaro_tpu.kernels.qc import qc_metrics as ref_qc
from saguaro_tpu.kernels.qc import qc_metrics_batch as ref_qc_batch
from saguaro_tpu_torch.kernels import illum, maxproj, qc

from .torch_data import share_cpu_threads

share_cpu_threads()


def test_max_project_exact_uint16():
    stack = np.random.default_rng(0).integers(0, 65535, (3, 40, 52)).astype(np.uint16)
    got = maxproj.max_project(torch.from_numpy(stack))
    assert got.dtype == torch.uint16
    assert np.array_equal(got.numpy(), np.asarray(ref_max_project(stack)))
    assert np.array_equal(got.numpy(), np.maximum.reduce(list(stack)))


@pytest.mark.parametrize("dtype", [np.uint16, np.uint8, np.float32])
def test_max_project_batch_exact(dtype):
    rng = np.random.default_rng(1)
    stacks = (rng.random((4, 5, 24, 30)) * np.iinfo(np.uint8).max).astype(dtype)
    got = maxproj.max_project_batch(torch.from_numpy(stacks)).numpy()
    assert got.dtype == dtype
    assert np.array_equal(got, np.asarray(ref_max_project_batch(stacks)))


def test_illum_correct():
    rng = np.random.default_rng(2)
    img = rng.integers(0, 65535, (40, 48)).astype(np.uint16)
    fn = rng.uniform(0.5, 1.5, (40, 48)).astype(np.float32)
    got = illum.illum_correct(torch.from_numpy(img), torch.from_numpy(fn)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref_correct(img, fn)), rtol=1e-6)


@pytest.mark.parametrize("sigma", [4, 12])
def test_estimate_illumination(sigma):
    rng = np.random.default_rng(3 + sigma)
    yy, xx = np.mgrid[0:64, 0:80]
    vignette = 1.0 - 0.4 * (((yy - 30) / 64.0) ** 2 + ((xx - 45) / 80.0) ** 2)
    stack = (rng.integers(100, 600, (5, 64, 80)) * vignette).astype(np.float32)
    want = ref_estimate(stack, sigma=sigma)
    got = illum.estimate_illumination(stack, sigma=sigma, device="cpu")
    assert got.dtype == np.float32 and got.shape == (64, 80)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # a tensor is processed on its own device
    got_t = illum.estimate_illumination(torch.from_numpy(stack), sigma=sigma)
    np.testing.assert_allclose(got_t, want, rtol=1e-5)


def _qc_images():
    """Structured, noisy, flat and saturated images with an even pixel
    count (the median is the mean of the two middle values)."""
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:64, 0:72]
    blobs = np.zeros((64, 72))
    for _ in range(6):
        cy, cx, r = rng.uniform(8, 56), rng.uniform(8, 64), rng.uniform(3, 8)
        blobs += 2000.0 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))
    structured = (blobs + rng.integers(90, 110, (64, 72))).astype(np.uint16)
    noisy = rng.integers(0, 4000, (64, 72)).astype(np.uint16)
    flat = np.full((64, 72), 500, np.uint16)
    saturated = structured.copy()
    saturated[10:20, 10:30] = 65535
    return {"structured": structured, "noisy": noisy, "flat": flat, "saturated": saturated}


def _assert_qc_close(got_slope, got_pct, want_slope, want_pct):
    got_slope, want_slope = np.asarray(got_slope, np.float64), np.asarray(want_slope, np.float64)
    np.testing.assert_allclose(got_slope, want_slope, rtol=1e-4, atol=1e-6)
    assert np.array_equal(np.asarray(got_pct), np.asarray(want_pct))


@pytest.mark.parametrize("name", ["structured", "noisy", "flat", "saturated"])
def test_qc_metrics(name):
    img = _qc_images()[name]
    got = qc.qc_metrics(torch.from_numpy(img))
    want = ref_qc(img)
    _assert_qc_close(got[0].numpy(), got[1].numpy(), want[0], want[1])


def test_qc_metrics_batch_float_input():
    imgs = np.stack(list(_qc_images().values())).astype(np.float32) / 7.0
    got = qc.qc_metrics_batch(torch.from_numpy(imgs))
    want = ref_qc_batch(imgs)
    _assert_qc_close(got[0].numpy(), got[1].numpy(), want[0], want[1])
    assert float(got[0][0]) < 0  # structured -> negative power-law slope


@pytest.mark.parametrize("shape", [(23, 30), (16, 16)], ids=["23px", "16px"])
def test_qc_small_images_return_zero_slope(shape):
    img = np.random.default_rng(8).integers(0, 1000, (2,) + shape).astype(np.uint16)
    got = qc.qc_metrics_batch(torch.from_numpy(img))
    want = ref_qc_batch(img)
    assert ref_radius_labels(shape)[1] <= 2
    assert np.array_equal(got[0].numpy(), np.zeros(2, np.float32))
    _assert_qc_close(got[0].numpy(), got[1].numpy(), want[0], want[1])


def test_radius_labels_match_reference():
    for shape in [(64, 72), (1080, 1080), (23, 30)]:
        a, la = qc._radius_labels(shape)
        b, lb = ref_radius_labels(shape)
        assert la == lb and np.array_equal(a, b)
