"""``multichannel_stats``, ``edge_intensity_multichannel`` and
``radial_distribution_multichannel``: the port (plain forms on the CPU)
against the reference per site of a 64² batch (2 and 3 channels,
max_cells 16), each column within ``torch_data.feature_tolerance`` (the
reference sums through a bf16 hi + lo split, the port in f32), and the
port's fused measurement against them as its oracles (the check of
``tests/test_fused_measure.py``: rtol and atol 1e-4)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saguaro_tpu.kernels import multichannel as ref
from saguaro_tpu_torch.kernels import multichannel as port
from saguaro_tpu_torch.kernels.fused_measure import fused_object_features

from .torch_data import blob_sites, feature_tolerance, share_cpu_threads

share_cpu_threads()

MC = 16
H = W = 64


@pytest.fixture(scope="module", params=[2, 3], ids=["2ch", "3ch"])
def sites(request):
    return blob_sites(n_sites=2, h=H, w=W, n_ch=request.param, n_cells=9, seed=30 + request.param)


def _hold(name, got, want):
    """got (max_cells, ...) against the reference's, column by column."""
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    g = got.reshape(MC, -1)
    w = want.reshape(MC, -1)
    for j in range(w.shape[1]):
        tol = feature_tolerance(name, w[:, j], None, H, W)
        bad = ~(np.abs(g[:, j] - w[:, j]) <= tol)
        assert not bad.any(), (name, j, g[bad, j], w[bad, j])


def test_stats_match_reference(sites):
    img, lab = sites
    inten, corr = port.multichannel_stats(torch.from_numpy(img), torch.from_numpy(lab), MC)
    for s in range(len(img)):
        r_int, r_corr = ref.multichannel_stats(jnp.asarray(img[s]), jnp.asarray(lab[s]), MC)
        assert set(inten) == set(r_int) and set(corr) == set(r_corr)
        for k, v in r_int.items():
            _hold(f"Intensity_{k}", inten[k][s].numpy(), v)
        for pair, (c, sl) in r_corr.items():
            _hold("Correlation_Correlation", corr[pair][0][s].numpy(), c)
            _hold("Correlation_Slope", corr[pair][1][s].numpy(), sl)


def test_edge_matches_reference(sites):
    img, lab = sites
    got = port.edge_intensity_multichannel(torch.from_numpy(img), torch.from_numpy(lab), MC)
    for s in range(len(img)):
        want = ref.edge_intensity_multichannel(jnp.asarray(img[s]), jnp.asarray(lab[s]), MC)
        assert set(got) == set(want)
        for k, v in want.items():
            _hold(f"Intensity_{k}", got[k][s].numpy(), v)


@pytest.mark.parametrize("n_rings", [4, 3])
def test_radial_matches_reference(sites, n_rings):
    img, lab = sites
    got = port.radial_distribution_multichannel(torch.from_numpy(img), torch.from_numpy(lab), MC,
                                                n_rings)
    for s in range(len(img)):
        want = ref.radial_distribution_multichannel(jnp.asarray(img[s]), jnp.asarray(lab[s]), MC,
                                                    n_rings)
        assert set(got) == set(want)
        for k, v in want.items():
            _hold(f"RadialDistribution_{k}", got[k][s].numpy(), v)


def test_fused_measurement_matches_oracles(sites):
    img, lab = sites
    im, lb = torch.from_numpy(img), torch.from_numpy(lab)
    fused = fused_object_features(im, lb, MC, n_rings=4, with_zernike=False)
    inten, corr = port.multichannel_stats(im, lb, MC)
    for k, v in inten.items():
        np.testing.assert_allclose(fused["intensity"][k].numpy(), v.numpy(), rtol=1e-4, atol=1e-4,
                                   err_msg=f"intensity {k}")
    for pair, (c, sl) in corr.items():
        np.testing.assert_allclose(fused["corr"][pair][0].numpy(), c.numpy(), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(fused["corr"][pair][1].numpy(), sl.numpy(), rtol=1e-4, atol=1e-4)
    for k, v in port.edge_intensity_multichannel(im, lb, MC).items():
        np.testing.assert_allclose(fused["edge"][k].numpy(), v.numpy(), rtol=1e-4, atol=1e-4,
                                   err_msg=f"edge {k}")
    for k, v in port.radial_distribution_multichannel(im, lb, MC, 4).items():
        np.testing.assert_allclose(fused["radial"][k].numpy(), v.numpy(), rtol=1e-4, atol=1e-4,
                                   err_msg=f"radial {k}")
