"""The port's Lanczos re-binning (``saguaro_tpu_torch.kernels.resample``,
plain form on the CPU) against the JAX package's XLA path on the same
seeded inputs: uint16 results within 1 integer unit (two f32 summation
orders, then round-half-up), f32 results to 1e-5 relative. The weight
tables K7 reads are held bit for bit against the reference's matrices, and
the plain form against the Pallas kernel in interpret mode."""

import numpy as np
import pytest
import torch

from saguaro_tpu.kernels.resample import _axis_matrix as ref_axis_matrix
from saguaro_tpu.kernels.resample import bicubic_axis_matrix as ref_bicubic
from saguaro_tpu.kernels.resample import lanczos_resize as ref_resize
from saguaro_tpu.kernels.resample import lanczos_resize_batch as ref_resize_batch
from saguaro_tpu.kernels.resample_pallas import lanczos_resize_pallas
from saguaro_tpu_torch.kernels import resample as rs

from .torch_data import share_cpu_threads

share_cpu_threads()


def _max_unit_diff(a, b):
    return int(np.abs(np.asarray(a).astype(np.int64) - np.asarray(b).astype(np.int64)).max())


@pytest.mark.parametrize(
    "in_shape,out_shape",
    [((512, 512), (256, 256)), ((270, 360), (135, 180)), ((96, 96), (48, 48)),
     ((40, 56), (97, 71))],
    ids=["512-256", "270x360-135x180", "96-48", "up-40x56-97x71"],
)
def test_single_image_uint16(in_shape, out_shape):
    img = np.random.default_rng(1).integers(0, 65535, in_shape).astype(np.uint16)
    got = rs.lanczos_resize(torch.from_numpy(img), out_shape)
    want = np.asarray(ref_resize(img, out_shape))
    assert got.dtype == torch.uint16 and tuple(got.shape) == want.shape
    assert _max_unit_diff(got.numpy(), want) <= 1


@pytest.mark.parametrize("batch", [1, 3])
def test_batch_uint16(batch):
    imgs = np.random.default_rng(2).integers(0, 65535, (batch, 130, 150)).astype(np.uint16)
    got = rs.lanczos_resize_batch(torch.from_numpy(imgs), (64, 77)).numpy()
    want = np.asarray(ref_resize_batch(imgs, (64, 77)))
    assert got.shape == want.shape == (batch, 64, 77)
    assert _max_unit_diff(got, want) <= 1


def test_uint8_clips_like_pil():
    img = np.random.default_rng(3).integers(0, 256, (2, 64, 64)).astype(np.uint8)
    img[:, 20:40, 20:40] = 255  # overshoot at the edges of a bright square
    got = rs.lanczos_resize_batch(torch.from_numpy(img), (32, 32)).numpy()
    want = np.asarray(ref_resize_batch(img, (32, 32)))
    assert got.dtype == np.uint8
    assert _max_unit_diff(got, want) <= 1


@pytest.mark.parametrize("out_shape", [(48, 40), (150, 111)], ids=["down", "up"])
def test_float32(out_shape):
    imgs = np.random.default_rng(4).normal(100.0, 30.0, (2, 96, 80)).astype(np.float32)
    got = rs.lanczos_resize_batch(torch.from_numpy(imgs), out_shape).numpy()
    want = np.asarray(ref_resize_batch(imgs, out_shape))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("sizes", [(2160, 1080), (1001, 433), (1537, 761), (40, 97), (56, 71),
                                   (7, 3)])
def test_axis_tables_match_reference_bit_for_bit(sizes):
    in_size, out_size = sizes
    ref = ref_axis_matrix(in_size, out_size).astype(np.float32)
    assert np.array_equal(rs.lanczos_matrices((in_size, 8), (out_size, 4))[0], ref)
    start, n, w = rs.axis_windows(in_size, out_size)
    dense = np.zeros_like(ref)
    for o in range(out_size):
        assert 0 <= start[o] and start[o] + n[o] <= in_size
        assert not w[o, n[o]:].any()
        dense[o, start[o] : start[o] + n[o]] = w[o, : n[o]]
    assert np.array_equal(dense, ref)


def test_bicubic_matrix_matches_reference():
    assert np.array_equal(rs.bicubic_axis_matrix(200, 480), ref_bicubic(200, 480))


def test_plain_form_matches_pallas_interpret():
    img = np.random.default_rng(5).integers(0, 65535, (270, 360)).astype(np.uint16)
    want = np.asarray(lanczos_resize_pallas(img, (135, 180), interpret=True))
    got = rs.lanczos_resize(torch.from_numpy(img), (135, 180)).numpy()
    assert _max_unit_diff(got, want) <= 1


def test_magnitude_scale_bounds_the_sum():
    imgs = torch.from_numpy(np.random.default_rng(6).normal(0, 1, (1, 64, 48)).astype(np.float32))
    val = rs.resize_plain(imgs, (20, 30), dtype=torch.float64)
    mag = rs.resize_plain(imgs, (20, 30), magnitude=True, dtype=torch.float64)
    assert torch.all(val.abs() <= mag + 1e-12) and torch.all(mag > 0)
