"""Quantile intensities and neighbours: the port (plain forms on the CPU)
against the reference, per site of a batch.

* integer-grid quantiles (uint16 data): exact order statistics, so the
  median and MAD are equal and the interpolated quartiles equal to 1 ulp;
* the adaptive-grid path (float data): each statistic lands on the same
  16-bit per-object grid, equal to 1e-6 relative + 1e-6 of the object's
  range (one rounding of the grid decode);
* NumberOfNeighbors exact, PercentTouching to 1 ulp (exact counts);
* the one-channel forms: quantiles as the multichannel ones, the Edge set
  (sums within 2**-15 of their size, min/max exact) and the radial
  distribution (within ``torch_data.feature_tolerance``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saguaro_tpu.kernels import objects_extra as ref
from saguaro_tpu_torch.kernels import objects_extra as port

from .torch_data import blob_sites, feature_tolerance, share_cpu_threads

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


# --------------------------------------------------------------------------
# The one-channel forms


@pytest.mark.parametrize("with_stats", [False, True])
def test_quantile_intensity_features(sites, with_stats):
    """The multichannel path on one channel: the median and MAD exact, the
    interpolated quartiles to 1 ulp; ``stats`` given as (cnt, vmin, vmax)."""
    from saguaro_tpu.kernels.segment_reduce import segment_stats as ref_stats
    from saguaro_tpu_torch.kernels.segment_reduce import segment_stats

    img, lab = sites
    v = img[..., 2]
    kw = {}
    if with_stats:
        cnt, _, _, vmin, vmax = segment_stats(torch.from_numpy(v), torch.from_numpy(lab), MC)
        kw["stats"] = (cnt, vmin, vmax)
    got = port.quantile_intensity_features(torch.from_numpy(v), torch.from_numpy(lab), MC, **kw)
    for s in range(len(lab)):
        kw_r = {}
        if with_stats:
            c, _, _, mn, mx = ref_stats(jnp.asarray(v[s]), jnp.asarray(lab[s]), MC)
            kw_r["stats"] = (c, mn, mx)
        want = ref.quantile_intensity_features(jnp.asarray(v[s]), jnp.asarray(lab[s]), MC, **kw_r)
        assert set(got) == set(want)
        for k, w in want.items():
            g = got[k][s].numpy()
            if k in ("MedianIntensity", "MADIntensity"):
                np.testing.assert_array_equal(g, np.asarray(w), err_msg=k)
            else:
                np.testing.assert_allclose(g, np.asarray(w), rtol=2**-23, atol=0, err_msg=k)


def test_edge_intensity_features(sites):
    """Counts (through the sums), min and max exact; the sums within 2**-15
    of each label's sum of |value|, the mean and std within
    feature_tolerance."""
    import pandas as pd

    img, lab = sites
    _, h, w, _ = img.shape
    v = img[..., 1]
    got = port.edge_intensity_features(torch.from_numpy(v), torch.from_numpy(lab), MC)
    for s in range(len(lab)):
        want = ref.edge_intensity_features(jnp.asarray(v[s]), jnp.asarray(lab[s]), MC)
        assert set(got) == set(want)
        for k, wv in want.items():
            wv = np.asarray(wv, np.float64)
            g = got[k][s].numpy().astype(np.float64)
            if k == "IntegratedIntensityEdge":
                tol = 2.0**-15 * np.abs(wv)  # non-negative values: |sum| = sum of |value|
            else:
                tol = feature_tolerance(f"Intensity_{k}_GFP", wv, pd.DataFrame(), h, w)
            assert np.all(np.abs(g - wv) <= tol), k
    assert got["MinIntensityEdge"].max() > 0


@pytest.mark.parametrize("n_rings", [4, 3])
def test_radial_distribution_features(sites, n_rings):
    """Ring binning is a floor, so the rings equal the reference's (its
    rounding of the distance is copied); FracAtD and MeanFrac within
    feature_tolerance."""
    import pandas as pd

    img, lab = sites
    _, h, w, _ = img.shape
    v = img[..., 0]
    got = port.radial_distribution_features(torch.from_numpy(v), torch.from_numpy(lab), MC, n_rings)
    for s in range(len(lab)):
        want = ref.radial_distribution_features(jnp.asarray(v[s]), jnp.asarray(lab[s]), MC, n_rings)
        assert set(got) == set(want)
        for k, wv in want.items():
            wv = np.asarray(wv, np.float64)
            g = got[k][s].numpy().astype(np.float64)
            assert g.shape == (MC, n_rings)
            tol = feature_tolerance(f"RadialDistribution_{k}_DNA_1of{n_rings}", wv, pd.DataFrame(),
                                    h, w)
            assert np.all(np.abs(g - wv) <= tol), k
    assert got["FracAtD"].max() > 0
