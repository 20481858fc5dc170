"""Secondary/tertiary objects and granularity: the port against the
reference. Label races and dilations are exact (the same f32 step costs
and strict comparisons). Granularity spectra agree to 1e-4 of the
spectrum's largest value: each entry is a mean over the plane, summed in
another order than XLA's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saguaro_tpu.kernels import morphology as ref
from saguaro_tpu.kernels.thresholding import global_threshold as ref_threshold
from saguaro_tpu_torch.kernels import morphology as port

from .torch_data import blob_sites, share_cpu_threads

share_cpu_threads()


@pytest.fixture(scope="module")
def sites():
    img, lab = blob_sites(n_sites=2, h=56, w=60, n_ch=3, n_cells=8, seed=13, overflow_id=None)
    body = img[..., 1:].mean(axis=-1)
    thr = np.array([float(ref_threshold(body[s])[0]) for s in range(len(body))], np.float32)
    return img, lab, body, thr


@pytest.mark.parametrize("iterations", [None, 3])
def test_propagate_labels_exact(sites, iterations):
    _, lab, body, thr = sites
    mask = body >= thr[:, None, None]
    got = port.propagate_labels(
        torch.from_numpy(lab), torch.from_numpy(body), torch.from_numpy(thr),
        iterations=iterations, regularization=0.05, mask=torch.from_numpy(mask),
    ).numpy()
    for s in range(len(lab)):
        want = np.asarray(ref.propagate_labels(
            lab[s], body[s], thr[s], iterations=iterations, regularization=0.05, mask=mask[s]
        ))
        np.testing.assert_array_equal(got[s], want)
    assert (got > 0).sum() > (lab > 0).sum()  # cells grew past the nuclei


def test_propagate_labels_threshold_without_mask(sites):
    _, lab, body, thr = sites
    got = port.propagate_labels(torch.from_numpy(lab), torch.from_numpy(body), float(thr[0])).numpy()
    for s in range(len(lab)):
        want = np.asarray(ref.propagate_labels(lab[s], body[s], float(thr[0])))
        np.testing.assert_array_equal(got[s], want)


def test_expand_and_tertiary_exact(sites):
    _, lab, body, thr = sites
    got = port.expand_labels(torch.from_numpy(lab), torch.from_numpy(body), torch.from_numpy(thr), 4)
    cyto = port.tertiary_objects(got, torch.from_numpy(lab)).numpy()
    for s in range(len(lab)):
        want = ref.expand_labels(lab[s], body[s], thr[s], iterations=4)
        np.testing.assert_array_equal(got[s].numpy(), np.asarray(want))
        np.testing.assert_array_equal(cyto[s], np.asarray(ref.tertiary_objects(want, lab[s])))


@pytest.mark.parametrize("radius", [1, 3])
def test_grey_disk_exact(sites, radius):
    img = sites[0][..., 0]
    for op, jop in (("min", jax.lax.min), ("max", jax.lax.max)):
        got = port._grey_disk(torch.from_numpy(img), radius, op).numpy()
        want = np.asarray(jax.vmap(lambda x: ref._grey_disk(x, radius, jop))(jnp.asarray(img)))
        np.testing.assert_array_equal(got, want)


def test_granularity_spectrum_close(sites):
    img = np.ascontiguousarray(sites[0][..., 0])
    kw = dict(spectrum_length=6, subsample_size=0.5, image_sample_size=0.5, element_size=3)
    got = port.granularity_spectrum_cp(torch.from_numpy(img), **kw).numpy()
    for s in range(len(img)):
        want = np.asarray(ref.granularity_spectrum_cp(img[s], **kw))
        np.testing.assert_allclose(got[s], want, rtol=0, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("length", [8, 16])
def test_legacy_granularity_spectrum_matches_reference(sites, length):
    """Within 1e-6 of the spectrum's largest element: each element is the
    difference of two f32 image means, summed in another order on each side
    (where the exact value is 0 the reference gives about -1e-6)."""
    img = np.ascontiguousarray(sites[0][..., 0])
    got = port.granularity_spectrum(torch.from_numpy(img), length).numpy()
    assert got.shape == (len(img), length)
    for s in range(len(img)):
        want = np.asarray(ref.granularity_spectrum(jnp.asarray(img[s]), length))
        np.testing.assert_allclose(got[s], want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_legacy_granularity_spectrum_shape():
    """The reference's shape and monotonicity check
    (``tests/test_features.py``) on the port: fine noise loses most of its
    volume at small radii."""
    rng = np.random.default_rng(0)
    img = rng.random((2, 64, 64)).astype(np.float32)
    g = port.granularity_spectrum(torch.from_numpy(img), 8).numpy()
    assert g.shape == (2, 8)
    assert np.isfinite(g).all()
    assert (g[:, 0] > g[:, -1]).all()
