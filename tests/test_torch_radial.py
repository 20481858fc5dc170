"""CP radial-distribution geometry: the port's two centre races against the
reference's, and the packed ring/wedge code against the reference's
``cp_ring_wedge``, exactly. Both packages' ``cp_ring_wedge`` run the
min-plus scan race (``center_race_scan``), which the port holds bit for bit
to the reference's (distances and winners) on blob sites, a spiral and
mirror-symmetric touching pairs (exact ties), and its associative scan
bit for bit to ``jax.lax.associative_scan``. The 1-step sweep race
(``center_race``) is bit-equal to the reference's sweep; the two forms add
the same steps in other orders, so against the scan race its distances
agree to 1e-4."""

import jax
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


# --------------------------------------------------------------------------
# The min-plus scan race, bit for bit


def _spiral():
    """tests/test_radial_cp.py's spiral: the most path bends, the scan
    race's worst case."""
    lab = np.zeros((1, 64, 64), np.int32)
    yy, xx = np.mgrid[:64, :64]
    th = np.arctan2(yy - 32, xx - 32)
    r = np.hypot(yy - 32, xx - 32)
    m = np.abs(r - (th + np.pi) * 4.0) < 2.5
    m |= np.abs(r - (th + 3 * np.pi) * 4.0) < 2.5
    lab[0][m & (r < 30)] = 1
    return lab


def _mirror_pairs():
    """Touching pairs of objects, each the mirror image of its partner about
    a pixel column (or row) held by the first, with mirrored seeds: the
    pixels on the axis are reached from both centres at exactly equal
    distances (the own-label tie rule decides them)."""
    lab = np.zeros((2, 41, 63), np.int32)
    yy, xx = np.mgrid[:41, :63]
    # site 0: ellipses mirrored about x = 31
    left = ((yy - 20) / 14.0) ** 2 + ((xx - 22) / 11.0) ** 2 <= 1.0
    lab[0][left & (xx <= 31)] = 1
    lab[0][np.fliplr(left) & (xx > 31)] = 2
    # site 1: diamonds mirrored about y = 20, and a lone disk
    top = np.abs(yy - 11) + np.abs(xx - 20) <= 10
    lab[1][top & (yy <= 20)] = 3
    lab[1][np.flipud(top) & (yy > 20)] = 4
    lab[1][np.hypot(yy - 20, xx - 50) <= 8] = 5
    return lab


def _race_cases():
    _, blobs = blob_sites(n_sites=2, h=56, w=64, n_ch=1, n_cells=12, seed=21)
    mirror = _mirror_pairs()
    seeds = np.zeros_like(mirror)
    seeds[0, 20, 24], seeds[0, 20, 38] = 1, 2
    seeds[1, 12, 20], seeds[1, 28, 20] = 3, 4
    seeds[1, 20, 50] = 5
    return {"blobs": (blobs, _seeds(blobs)), "spiral": (_spiral(), _seeds(_spiral())),
            "mirror pairs": (mirror, seeds)}


@pytest.mark.parametrize("case", ["blobs", "spiral", "mirror pairs"])
@pytest.mark.parametrize("lam", [1.0, 0.25])
def test_center_race_scan_bit_equal(case, lam):
    lab, seeds = _race_cases()[case]
    d, won = (a.numpy() for a in port.center_race_scan(torch.from_numpy(lab),
                                                        torch.from_numpy(seeds), lam))
    for s in range(len(lab)):
        d_ref, w_ref = map(np.asarray, ref.center_race_scan(jnp.asarray(lab[s]),
                                                            jnp.asarray(seeds[s]), lam))
        np.testing.assert_array_equal(d[s], d_ref)
        np.testing.assert_array_equal(won[s], w_ref)
    inside = lab > 0
    assert (won[inside] > 0).all() and (d[~inside] == np.float32(port._BIG)).all()


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("n", [1, 2, 3, 1080, 1081])
def test_minplus_scan_bit_equal_to_associative_scan(n, reverse):
    """Seeded f32 (c, k, w) triples, some steps blocked (3.4e38), along the
    last of three axes and along the first."""
    rng = np.random.default_rng(n)
    c = rng.uniform(0.0, 200.0, (3, n)).astype(np.float32)
    c[rng.random((3, n)) < 0.2] = np.float32(port._BIG)
    k = rng.uniform(0.1, 1.5, (3, n)).astype(np.float32)
    k[rng.random((3, n)) < 0.1] = np.float32(port._BIG)
    w = rng.integers(0, 9, (3, n)).astype(np.int32)
    for axis, tr in ((1, lambda a: a), (0, lambda a: np.ascontiguousarray(a.T))):
        c_w = port.minplus_scan(*(torch.from_numpy(tr(a)) for a in (c, k, w)), axis, reverse=reverse)
        args = [tr(a) for a in (c, k, w)]
        scan = jax.jit(lambda e, axis=axis: jax.lax.associative_scan(
            ref._minplus_combine, e, axis=axis, reverse=reverse))
        want = scan(tuple(map(jnp.asarray, args)))
        got = port.minplus_scan(*map(torch.from_numpy, args), axis, reverse=reverse, with_k=True)
        for g, wt in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(wt))
        # without k the race's outputs are the same
        for g, wt in zip(c_w, (want[0], want[2])):
            np.testing.assert_array_equal(g.numpy(), np.asarray(wt))


def test_cp_ring_wedge_runs_the_scan_race(labels, monkeypatch):
    calls = []
    real = port.center_race_scan
    monkeypatch.setattr(port, "center_race_scan", lambda *a, **k: calls.append(1) or real(*a, **k))
    port.cp_ring_wedge(torch.from_numpy(labels), MC, 4, 64)
    assert calls == [1]
