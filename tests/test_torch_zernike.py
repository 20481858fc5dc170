"""Zernike shape moments: the port's ``zernike_features`` (plain forms on
the CPU) against the reference's, per site of a batch, and against the
fused measurement's Zernike family. Magnitudes are O(1) by normalisation
and sums of 1e2-1e3 pixel terms: 1e-5 absolute, as
``torch_data.feature_tolerance`` holds the measurement's Zernike columns."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saguaro_tpu.kernels import zernike as ref
from saguaro_tpu_torch.kernels import zernike as port
from saguaro_tpu_torch.kernels.fused_measure import fused_object_features

from .torch_data import blob_sites, share_cpu_threads

share_cpu_threads()

ATOL = 1e-5


@pytest.fixture(scope="module")
def sites():
    return blob_sites(n_sites=2, h=56, w=64, n_ch=1, n_cells=10, seed=13)


@pytest.mark.parametrize("max_cells", [16, 8])
def test_zernike_features_match_reference(sites, max_cells):
    """max_cells 8 folds some objects into slot 0 with the overflow id."""
    _, lab = sites
    got = port.zernike_features(torch.from_numpy(lab), max_cells).numpy()
    assert got.shape == (len(lab), max_cells, len(port.ZERNIKE_INDEXES))
    for s in range(len(lab)):
        want = np.asarray(ref.zernike_features(jnp.asarray(lab[s]), max_cells))
        np.testing.assert_allclose(got[s], want, rtol=0, atol=ATOL)
    assert np.abs(got).max() > 0.1


def test_zernike_features_empty_labels_are_zero(sites):
    _, lab = sites
    got = port.zernike_features(torch.from_numpy(lab), 16).numpy()
    present = np.zeros((len(lab), 16), bool)
    for s in range(len(lab)):
        ids = np.unique(lab[s])
        present[s, ids[ids < 16]] = True
    assert not got[~present].any()


def test_zernike_features_equal_the_fused_family(sites):
    img, lab = sites
    fused = fused_object_features(torch.from_numpy(img), torch.from_numpy(lab), 16, n_rings=4)
    got = port.zernike_features(torch.from_numpy(lab), 16)
    np.testing.assert_allclose(got[:, 1:].numpy(), fused["zernike"][:, 1:].numpy(), rtol=0,
                               atol=ATOL)


def test_index_order_matches_reference():
    assert port.ZERNIKE_INDEXES == ref.ZERNIKE_INDEXES
    np.testing.assert_array_equal(port._radial_coeffs(), ref._radial_coeffs())
