"""fused_object_features: the port (plain forms on the CPU) against the
reference, every key of every family, per site of a 2-site batch, the
radial-distribution family with CP ring/wedge codes and with centroid
binning. Tolerances per column: ``torch_data.feature_tolerance``."""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from saguaro_tpu.kernels.fused_measure import fused_object_features as ref_fused
from saguaro_tpu.kernels.radial import cp_ring_wedge as ref_ring_wedge
from saguaro_tpu_torch.kernels.fused_measure import fused_object_features

from .torch_data import blob_sites, feature_tolerance, share_cpu_threads

share_cpu_threads()

MC = 16


def _flatten(out, s=None):
    """Family dict -> {column: (max_cells,) array} for site s (port) or the
    single-site reference (s=None)."""
    pick = (lambda a: np.asarray(a)) if s is None else (lambda a: a[s].numpy())
    cols = {}
    for fam in ("shape", "moments", "intensity", "edge"):
        for k, v in (out[fam] or {}).items():
            v = pick(v)
            if v.ndim == 2:
                for c in range(v.shape[1]):
                    cols[f"{fam}_{k}_{c}"] = v[:, c]
            else:
                cols[f"{fam}_{k}"] = v
    if out["zernike"] is not None:
        z = pick(out["zernike"])
        for i in range(z.shape[1]):
            cols[f"Zernike_{i}"] = z[:, i]
    for (a, b), (c, sl) in out["corr"].items():
        cols[f"corr_{a}{b}"], cols[f"slope_{a}{b}"] = pick(c), pick(sl)
    for (a, b), vals in out["coloc_quad"].items():
        for i, v in enumerate(vals):
            cols[f"coloc_{a}{b}_{i}"] = pick(v)
    cnt, vmin, vmax = out["stats"]
    cols["stats_cnt"] = pick(cnt)
    return cols


@pytest.fixture(scope="module")
def sites():
    return blob_sites(n_sites=2, h=56, w=64, n_ch=3, n_cells=9, seed=7)


@pytest.mark.parametrize(
    "moments,zernike,edge", [(True, True, True), (False, False, False)]
)
def test_fused_object_features_matches_reference(sites, moments, zernike, edge):
    img, lab = sites
    got = fused_object_features(
        torch.from_numpy(img), torch.from_numpy(lab), MC, with_moments=moments,
        with_zernike=zernike, with_edge=edge, with_radial=False,
    )
    assert got["radial"] is None
    for s in range(len(img)):
        want = ref_fused(
            img[s], lab[s], MC, with_moments=moments, with_zernike=zernike, with_edge=edge,
            with_radial=False,
        )
        g, w = _flatten(got, s), _flatten(want)
        assert set(g) == set(w)
        ref_table = pd.DataFrame({
            "AreaShape_Area": w["shape_Area"],
            **{f"AreaShape_BoundingBox{k}": w[f"shape_BoundingBox{k}"]
               for k in ("Maximum_Y", "Minimum_Y", "Maximum_X", "Minimum_X")},
        })
        for col in w:
            name = col.replace("shape_", "AreaShape_").replace("moments_", "AreaShape_")
            name = name.replace("intensity_", "Intensity_").replace("edge_", "Intensity_")
            name = name.replace("stats_cnt", "AreaShape_Area")
            tol = feature_tolerance(name, w[col], ref_table, *img.shape[1:3])
            bad = ~(np.abs(g[col].astype(np.float64) - w[col]) <= tol)
            assert not bad.any(), (col, w[col][bad], g[col][bad])


@pytest.mark.parametrize("binning,n_rings", [("cp", 4), ("centroid", 4), ("cp", 3)])
def test_radial_family_matches_reference(sites, binning, n_rings):
    img, lab = sites
    b, h, w, n_ch = img.shape
    rw = None
    if binning == "cp":
        rw = np.stack([np.asarray(ref_ring_wedge(jnp.asarray(lab[s]), MC, n_rings, 64))
                       for s in range(b)])
    got = fused_object_features(
        torch.from_numpy(img), torch.from_numpy(lab), MC, n_rings=n_rings,
        ring_wedge=None if rw is None else torch.from_numpy(rw),
    )["radial"]
    for s in range(b):
        want = ref_fused(img[s], lab[s], MC, n_rings=n_rings,
                         ring_wedge=None if rw is None else jnp.asarray(rw[s]))["radial"]
        assert set(got) == set(want) == {"FracAtD", "MeanFrac", "RadialCV"}
        for k, v in want.items():
            v = np.asarray(v, np.float64)
            assert got[k][s].shape == v.shape == (MC, n_rings, n_ch)
            for r in range(n_rings):
                for c in range(n_ch):
                    col = v[:, r, c]
                    tol = feature_tolerance(f"RadialDistribution_{k}", col, None, h, w)
                    bad = ~(np.abs(got[k][s, :, r, c].numpy() - col) <= tol)
                    assert not bad.any(), (k, r, c, np.nonzero(bad)[0], col[bad])


def _sliver_site(seed: int = 0, size: int = 96):
    """One site of objects of 3 or 4 scattered pixels (a cytoplasm's
    slivers between touching cells: the first three are the end-to-end
    screen's, plate 2 at 6 h, first site), whose Zernike radials the
    reference evaluates where their f32 terms cancel most, and one disk."""
    rng = np.random.default_rng(seed)
    lab = np.zeros((size, size), np.int32)
    objects = [[(46, 74), (46, 75), (51, 84), (52, 84)], [(56, 74), (57, 74), (64, 59)],
               [(18, 45), (19, 36), (24, 49)]]
    for k in range(8):
        y, x = 4 + 11 * k, int(rng.integers(2, 30))
        objects.append([(y + int(rng.integers(0, 8)), x + int(rng.integers(0, 14)))
                        for _ in range(3 + k % 2)])
    for k, pixels in enumerate(objects, start=1):
        for y, x in pixels:
            lab[y, x] = k
    yy, xx = np.mgrid[:size, :size]
    lab[(yy - 80) ** 2 + (xx - 30) ** 2 <= 16] = len(objects) + 1
    img = rng.integers(100, 3000, (size, size, 2)).astype(np.float32)
    return img[None], lab[None]


def test_zernike_of_small_objects_matches_reference():
    """A 4-pixel object's R_9^1 is a sum of terms up to 280 rho^7 that
    cancel to about 1: the port raises rho to each power and sums the
    radial's terms as the reference rounds them (JAX's integer powers, one
    fused multiply-add a power), else the two part by 1.9e-5."""
    img, lab = _sliver_site()
    got = fused_object_features(torch.from_numpy(img), torch.from_numpy(lab), MC,
                                with_moments=False, with_zernike=True, with_edge=False,
                                with_radial=False)["zernike"][0].numpy()
    want = np.asarray(ref_fused(img[0], lab[0], MC, with_moments=False, with_zernike=True,
                                with_edge=False, with_radial=False)["zernike"])
    assert (want[1:12].max(axis=1) > 0.5).all()
    tol = feature_tolerance("AreaShape_Zernike_9_1", want, None, *img.shape[1:3])
    np.testing.assert_array_less(np.abs(got - want), tol + 1e-12)
