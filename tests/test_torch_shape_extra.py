"""AreaShape radii and convex hull: the port (plain forms on the CPU)
against the reference, per site of a batch.

* the label-aware squared EDT: exact (integer-valued f32, min and
  one-rounding adds in both);
* Median and Maximum radius: exact (order statistics of the integer squared
  distances); MeanRadius: 2**-15 relative (the reference sums distances
  through a bf16 hi/lo split, the port in f32);
* the convex hull: the support values are the same f32 products, so the
  extreme pixels agree and the hull area, Feret diameters and solidity are
  equal to 1e-5 relative (summation order of the shoelace); the dropped
  boundary pixel count is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saguaro_tpu.kernels import shape_extra as ref
from saguaro_tpu_torch.kernels import shape_extra as port

from .torch_data import blob_sites, share_cpu_threads

share_cpu_threads()

MC = 16


@pytest.fixture(scope="module")
def labels():
    _, lab = blob_sites(n_sites=2, h=56, w=64, n_ch=1, n_cells=11, seed=3)
    lab[1, 20:30, :] = 5  # a row-spanning band: its rows hold one label only
    return lab


@pytest.mark.parametrize("max_radius", [3, 64])
def test_label_edt_sq_exact(labels, max_radius):
    got = port._label_edt_sq(torch.from_numpy(labels), max_radius).numpy()
    for s in range(len(labels)):
        want = np.asarray(ref._label_edt_sq_impl(jnp.asarray(labels[s]), max_radius, False))
        np.testing.assert_array_equal(got[s], want)


def test_radius_features(labels):
    got = port.radius_features(torch.from_numpy(labels), MC, 48)
    for s in range(len(labels)):
        want = ref.radius_features(jnp.asarray(labels[s]), MC, 48)
        assert set(got) == set(want)
        for k in ("MedianRadius", "MaximumRadius"):
            np.testing.assert_array_equal(got[k][s].numpy(), np.asarray(want[k]), err_msg=k)
        w = np.asarray(want["MeanRadius"], np.float64)
        assert np.all(np.abs(got["MeanRadius"][s].numpy() - w) <= 2.0**-15 * w), "MeanRadius"


@pytest.mark.parametrize("max_boundary", [None, 150])
def test_convex_features(labels, max_boundary):
    got = port.convex_features(torch.from_numpy(labels), MC, 72, max_boundary=max_boundary)
    for s in range(len(labels)):
        want = ref.convex_features(jnp.asarray(labels[s]), MC, 72, max_boundary=max_boundary)
        assert set(got) == set(want)
        assert got["BoundaryOverflow"][s].item() == float(want["BoundaryOverflow"])
        for k in ("Solidity", "MaxFeretDiameter", "MinFeretDiameter", "ConvexArea"):
            w = np.asarray(want[k], np.float64)
            np.testing.assert_allclose(got[k][s].numpy(), w, rtol=1e-5, atol=1e-5, err_msg=k)
    if max_boundary:
        assert got["BoundaryOverflow"].min().item() > 0
