"""Quantile intensities and neighbours: the port (plain forms on the CPU)
against the reference, per site of a batch.

* integer-grid quantiles (uint16 data): exact order statistics, so the
  median and MAD are equal and the interpolated quartiles equal to 1 ulp;
* the adaptive-grid path (float data): each statistic lands on the same
  16-bit per-object grid, equal to 1e-6 relative + 1e-6 of the object's
  range (one rounding of the grid decode);
* NumberOfNeighbors exact, PercentTouching to 1 ulp (exact counts)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saguaro_tpu.kernels import objects_extra as ref
from saguaro_tpu_torch.kernels import objects_extra as port

from .torch_data import blob_sites, share_cpu_threads

share_cpu_threads()

MC = 16


@pytest.fixture(scope="module")
def sites():
    return blob_sites(n_sites=2, h=48, w=56, n_ch=3, n_cells=9, seed=41)


@pytest.mark.parametrize("integer_grid", [True, False])
def test_quantiles(sites, integer_grid):
    img, lab = sites
    if not integer_grid:
        img = img * np.float32(0.731) + np.float32(0.3)  # off the integer grid
    got = port.quantile_intensity_features_mc(torch.from_numpy(img), torch.from_numpy(lab), MC,
                                              integer_grid=integer_grid)
    for s in range(len(img)):
        want = ref.quantile_intensity_features_mc(jnp.asarray(img[s]), jnp.asarray(lab[s]), MC,
                                                  integer_grid=integer_grid)
        assert set(got) == set(want)
        span = np.ptp(img[s], axis=(0, 1))
        for k, v in want.items():
            w = np.asarray(v, np.float64)
            g = got[k][s].numpy().astype(np.float64)
            if integer_grid and k in ("MedianIntensity", "MADIntensity"):
                np.testing.assert_array_equal(g, w, err_msg=k)
            elif integer_grid:
                np.testing.assert_allclose(g, w, rtol=2**-23, atol=0, err_msg=k)
            else:
                assert np.all(np.abs(g - w) <= 1e-6 * np.abs(w) + 1e-6 * span), k


@pytest.mark.parametrize("distance", [5, 2, 0])
def test_neighbors(sites, distance):
    _, lab = sites
    got = port.neighbor_features(torch.from_numpy(lab), MC, distance)
    for s in range(len(lab)):
        want = ref.neighbor_features(jnp.asarray(lab[s]), MC, distance)
        np.testing.assert_array_equal(got["NumberOfNeighbors"][s].numpy(),
                                      np.asarray(want["NumberOfNeighbors"]))
        np.testing.assert_allclose(got["PercentTouching"][s].numpy(),
                                   np.asarray(want["PercentTouching"]), rtol=2**-23)
    assert got["NumberOfNeighbors"].max() > 0
