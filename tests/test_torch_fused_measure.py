"""fused_object_features: the port (plain forms on the CPU) against the
reference, every key of every family the slice computes, per site of a
2-site batch. Tolerances per column: ``torch_data.feature_tolerance``."""

import numpy as np
import pandas as pd
import pytest
import torch

from saguaro_tpu.kernels.fused_measure import fused_object_features as ref_fused
from saguaro_tpu_torch.kernels.fused_measure import fused_object_features

from .torch_data import blob_sites, feature_tolerance

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


def test_radial_lanes_not_ported(sites):
    img, lab = sites
    with pytest.raises(NotImplementedError, match="radial"):
        fused_object_features(torch.from_numpy(img), torch.from_numpy(lab), MC)
