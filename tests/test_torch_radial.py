"""CP radial-distribution geometry: the port's centre race (the 1-step
8-neighbour sweep, plain PyTorch) against the reference's sweep race and
its default min-plus scan race, and the packed ring/wedge code against the
reference's ``cp_ring_wedge`` (which runs the scan race). Distances agree
to 1e-4 (the two races add the same steps in other orders), winners and
ring/wedge codes exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saguaro_tpu.kernels import radial as ref
from saguaro_tpu_torch.kernels import radial as port

from .torch_data import blob_sites, share_cpu_threads

share_cpu_threads()

MC = 16


@pytest.fixture(scope="module")
def labels():
    _, lab = blob_sites(n_sites=2, h=56, w=64, n_ch=1, n_cells=12, seed=21)
    return lab


def _seeds(lab):
    seeds = np.zeros_like(lab)
    for s in range(len(lab)):
        for k in np.unique(lab[s][lab[s] > 0]):
            ys, xs = np.nonzero(lab[s] == k)
            seeds[s, ys[len(ys) // 3], xs[len(xs) // 3]] = k
    return seeds


@pytest.mark.parametrize("lam", [1.0, 0.25])
def test_center_race_matches_reference_races(labels, lam):
    """Bit-equal to the reference's sweep race. Against its scan race the
    distances agree to 1e-4 and the winners wherever the reference's two
    races agree: with these off-centre seeds they split 3 tie pixels of
    site 1 between touching objects."""
    seeds = _seeds(labels)
    d, won = (a.numpy() for a in port.center_race(torch.from_numpy(labels), torch.from_numpy(seeds), lam))
    for s in range(len(labels)):
        inside = labels[s] > 0
        d_sw, w_sw = map(np.asarray, ref.center_race(jnp.asarray(labels[s]), jnp.asarray(seeds[s]), lam))
        np.testing.assert_array_equal(d[s], d_sw)
        np.testing.assert_array_equal(won[s], w_sw)
        d_sc, w_sc = map(np.asarray, ref.center_race_scan(jnp.asarray(labels[s]), jnp.asarray(seeds[s]), lam))
        np.testing.assert_allclose(np.where(inside, d[s], 0), np.where(inside, d_sc, 0), atol=1e-4)
        agree = inside & (w_sw == w_sc)
        np.testing.assert_array_equal(won[s][agree], w_sc[agree])
        assert (inside & ~agree).sum() <= 3


@pytest.mark.parametrize("n_rings", [4, 3])
def test_cp_ring_wedge_exact(labels, n_rings):
    got = port.cp_ring_wedge(torch.from_numpy(labels), MC, n_rings, 64).numpy()
    for s in range(len(labels)):
        want = np.asarray(ref.cp_ring_wedge(jnp.asarray(labels[s]), MC, n_rings, 64))
        np.testing.assert_array_equal(got[s], want)
    assert (got == 8 * n_rings).any() and (got < 8 * n_rings).any()


def test_cp_ring_wedge_with_shared_edt_and_radius(labels):
    """The measurement's path: one EDT shared with the radii, MaximumRadius
    squared as the centre search's per-object maximum."""
    from saguaro_tpu_torch.kernels.shape_extra import _label_edt_sq, radius_features

    lab = torch.from_numpy(labels)
    d2 = _label_edt_sq(lab, 64)
    rmax = radius_features(lab, MC, 64, d2_img=d2)["MaximumRadius"]
    got = port.cp_ring_wedge(lab, MC, 4, 64, d2_img=d2, max_d2=rmax * rmax)
    assert torch.equal(got, port.cp_ring_wedge(lab, MC, 4, 64))
