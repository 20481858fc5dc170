"""Perimeter weights and Euler numbers: the port against the reference,
exactly (Euler contributions are small integers; perimeter weights are
predicates times three constants). The per-family API (segment_stats,
intensity, shape and correlation features): counts, areas, boxes and
min/max exactly, plain sums within 2**-15 of each label's sum of |value|,
derived columns within ``torch_data.feature_tolerance``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saguaro_tpu.kernels import segment_reduce as ref
from saguaro_tpu_torch.kernels import segment_reduce as port

from .torch_data import blob_sites, feature_tolerance, share_cpu_threads

share_cpu_threads()


@pytest.fixture(scope="module")
def labels():
    _, lab = blob_sites(n_sites=2, h=48, w=56, n_ch=1, n_cells=7, seed=5)
    return lab


def test_perimeter_weights_exact(labels):
    w_got, b_got = port.perimeter_weight_image(torch.from_numpy(labels))
    for s in range(len(labels)):
        w_want, b_want = ref.perimeter_weight_image(jnp.asarray(labels[s]))
        np.testing.assert_array_equal(b_got[s].numpy(), np.asarray(b_want))
        np.testing.assert_array_equal(w_got[s].numpy(), np.asarray(w_want))


@pytest.mark.parametrize("max_cells", [8, 64])
def test_euler_numbers_exact(labels, max_cells):
    got = port.euler_numbers(torch.from_numpy(labels), max_cells).numpy()
    want = np.asarray(jax.vmap(lambda lb: ref.euler_numbers(lb, max_cells))(jnp.asarray(labels)))
    np.testing.assert_array_equal(got, want)
    # object 1 carries a hole: Euler number 0
    assert got[0, 1] == 0.0 and got[0, 2] == 1.0


# --------------------------------------------------------------------------
# The per-family measurement API on blob sites (one overflow id), holding
# counts, areas and boxes exactly, plain sums within 2**-15 of each label's
# sum of |value| and derived columns within torch_data.feature_tolerance

MC = 16


@pytest.fixture(scope="module")
def sites():
    return blob_sites(n_sites=2, h=56, w=64, n_ch=2, n_cells=10, seed=3)


def _label_abs_sums(values, labels, max_cells):
    """Per label of each site, the f64 sum of |value| over ``labels > 0``
    (ids >= max_cells in slot 0)."""
    out = np.zeros((len(labels), max_cells))
    for s in range(len(labels)):
        lab = labels[s].reshape(-1)
        seg = np.where((lab > 0) & (lab < max_cells), lab, 0)
        v = np.abs(np.asarray(values[s], np.float64).reshape(-1)) * (lab > 0)
        out[s] = np.bincount(seg, v, max_cells)
    return out


def _hold_columns(got: dict, want_by_site: list, prefix: str, h: int, w: int):
    """Every column of every site within feature_tolerance of the reference
    (zero for the exact columns: areas, boxes, min/max and their places)."""
    import pandas as pd

    for s, want in enumerate(want_by_site):
        assert set(got) == set(want)
        for k, v in want.items():
            w_ = np.asarray(v, np.float64)
            g = got[k][s].numpy().astype(np.float64)
            tol = feature_tolerance(f"{prefix}{k}", w_, pd.DataFrame(), h, w)
            bad = ~(np.abs(g - w_) <= tol)
            assert not bad.any(), (k, np.argwhere(bad)[:3], g[bad][:3], w_[bad][:3])


def test_segment_stats(sites):
    img, lab = sites
    v = img[..., 0]
    got = [t.numpy().astype(np.float64) for t in
           port.segment_stats(torch.from_numpy(v), torch.from_numpy(lab), MC)]
    abs1 = _label_abs_sums(v, lab, MC)
    abs2 = _label_abs_sums(v.astype(np.float64) ** 2, lab, MC)
    for s in range(len(lab)):
        cnt, sm, ss, vmin, vmax = (np.asarray(a, np.float64) for a in
                                   ref.segment_stats(jnp.asarray(v[s]), jnp.asarray(lab[s]), MC))
        np.testing.assert_array_equal(got[0][s], cnt)
        assert np.all(np.abs(got[1][s] - sm) <= 2.0**-15 * abs1[s])
        assert np.all(np.abs(got[2][s] - ss) <= 2.0**-15 * abs2[s])
        np.testing.assert_array_equal(got[3][s], vmin)
        np.testing.assert_array_equal(got[4][s], vmax)
    assert got[0][:, 0].max() > 0  # the overflow object folds into slot 0


def test_intensity_features(sites):
    img, lab = sites
    _, h, w, _ = img.shape
    got = port.intensity_features(torch.from_numpy(img[..., 1]), torch.from_numpy(lab), MC)
    want = [ref.intensity_features(jnp.asarray(img[s, ..., 1]), jnp.asarray(lab[s]), MC)
            for s in range(len(lab))]
    _hold_columns(got, want, "Intensity_", h, w)
    for k in ("IntegratedIntensity",):
        abs1 = _label_abs_sums(img[..., 1], lab, MC)
        for s in range(len(lab)):
            diff = np.abs(got[k][s].numpy().astype(np.float64) - np.asarray(want[s][k], np.float64))
            assert np.all(diff <= 2.0**-15 * abs1[s])


def test_shape_features(sites):
    _, lab = sites
    _, h, w = lab.shape
    got = port.shape_features(torch.from_numpy(lab), MC)
    want = [ref.shape_features(jnp.asarray(lab[s]), MC) for s in range(len(lab))]
    _hold_columns(got, want, "AreaShape_", h, w)
    for k in ("Area", "BoundingBoxArea", "BoundingBoxMinimum_Y", "BoundingBoxMaximum_X"):
        for s in range(len(lab)):
            np.testing.assert_array_equal(got[k][s].numpy(), np.asarray(want[s][k]), err_msg=k)


@pytest.mark.parametrize("pair", [(0, 1), (1, 0)])
def test_correlation_features(sites, pair):
    img, lab = sites
    _, h, w, _ = img.shape
    a, b = pair
    got = port.correlation_features(torch.from_numpy(img[..., a]), torch.from_numpy(img[..., b]),
                                    torch.from_numpy(lab), MC)
    want = [ref.correlation_features(jnp.asarray(img[s, ..., a]), jnp.asarray(img[s, ..., b]),
                                     jnp.asarray(lab[s]), MC) for s in range(len(lab))]
    _hold_columns(got, want, "Correlation_", h, w)
    # one-pixel objects give 0, as the reference's n <= 1 rule
    one = np.zeros((1, 8, 8), np.int32)
    one[0, 3, 3] = 1
    z = port.correlation_features(torch.ones(1, 8, 8), torch.ones(1, 8, 8), torch.from_numpy(one), 4)
    assert float(z["Correlation"][0, 1]) == 0.0 and float(z["Slope"][0, 1]) == 0.0
