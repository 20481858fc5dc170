"""``moments_features``: the port (plain forms on the CPU) against the
reference per site of a 64² batch with max_cells 16, and the port's fused
measurement against it as its oracle (the check of
``tests/test_fused_measure.py``, rtol and atol 1e-4).

The reference sums the 32 power lanes through a bf16 hi + lo split, the
port in f32: the spatial and central moments are held to 1e-5 of their
scale (area x side^(p+q), ``torch_data.feature_tolerance``), the derived
columns as that module says."""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from saguaro_tpu.kernels.moments import moments_features as ref_moments
from saguaro_tpu_torch.kernels.fused_measure import fused_object_features
from saguaro_tpu_torch.kernels.moments import moments_features

from .torch_data import blob_sites, feature_tolerance, share_cpu_threads

share_cpu_threads()

MC = 16


@pytest.fixture(scope="module")
def sites():
    return blob_sites(n_sites=2, h=64, w=64, n_ch=2, n_cells=9, seed=12)


@pytest.fixture(scope="module")
def got(sites):
    _, lab = sites
    return moments_features(torch.from_numpy(lab), MC)


def _ref_table(lab):
    """Area and bounding box per slot: the scale of the moment tolerances."""
    rows = []
    for k in range(MC):
        ys, xs = np.nonzero(lab == k) if k else (np.zeros(0, int), np.zeros(0, int))
        rows.append((len(ys), ys.max(initial=0), ys.min(initial=0), xs.max(initial=0),
                     xs.min(initial=0)))
    return pd.DataFrame(rows, columns=["AreaShape_Area", "AreaShape_BoundingBoxMaximum_Y",
                                       "AreaShape_BoundingBoxMinimum_Y",
                                       "AreaShape_BoundingBoxMaximum_X",
                                       "AreaShape_BoundingBoxMinimum_X"])


@pytest.mark.parametrize("site", [0, 1])
def test_matches_reference_per_site(sites, got, site):
    _, lab = sites
    want = ref_moments(jnp.asarray(lab[site]), MC)
    assert set(got) == set(want)
    table = _ref_table(lab[site])
    for k, v in want.items():
        v = np.asarray(v, np.float64)
        g = got[k][site].numpy()
        assert g.shape == v.shape == (MC,)
        tol = feature_tolerance(f"AreaShape_{k}", v, table, 64, 64, hu_floor=1e-6)
        assert np.all(np.abs(g - v) <= tol), (k, g, v)


def test_fused_measurement_matches_oracle(sites, got):
    img, lab = sites
    fused = fused_object_features(torch.from_numpy(img), torch.from_numpy(lab), MC,
                                  with_zernike=False, with_edge=False, with_radial=False)
    for k, v in got.items():
        np.testing.assert_allclose(fused["moments"][k].numpy(), v.numpy(), rtol=1e-4, atol=1e-4,
                                   err_msg=f"moments {k}")


def test_hu_translation_invariance():
    lab = np.zeros((1, 64, 64), np.int32)
    lab[0, 5:15, 5:20] = 1
    lab[0, 40:50, 30:45] = 2
    got = moments_features(torch.from_numpy(lab), 8)
    for i in range(7):
        np.testing.assert_allclose(got[f"HuMoment_{i}"][0, 1].numpy(),
                                   got[f"HuMoment_{i}"][0, 2].numpy(), rtol=1e-3, atol=1e-9)


def test_background_slot_zero():
    lab = np.zeros((2, 16, 16), np.int32)
    lab[:, 4:8, 4:8] = 1
    for v in moments_features(torch.from_numpy(lab), 4).values():
        assert (v[:, 0] == 0.0).all()
