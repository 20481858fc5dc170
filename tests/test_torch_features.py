"""measure_site_batch: the port (plain forms on the CPU) against the
reference on a 2-site batch — the same 4 tables, column sets and
ObjectNumber rows, values within ``torch_data.feature_tolerance`` — at the
reference's default FeatureConfig (only channels and max_cells set), at
its centroid radial binning, adaptive threshold scope and smoothing at
binarisation, and at a config with the texture, quantile, radius, convex,
neighbour, colocalization and radial families off.

The reference measures a batch under ``vmap``; at adaptive scope that
program does not run on XLA:CPU (its batched bf16 gather product has no CPU
kernel), so that case takes the reference's single-site ``measure_site``.
``otsu_threshold`` (the whole-image Otsu) equals the reference's exactly."""

import numpy as np
import pytest
import torch

from saguaro_tpu.pipeline.features import FeatureConfig as RefFeatureConfig
from saguaro_tpu.pipeline.features import measure_site as ref_measure_site
from saguaro_tpu.pipeline.features import measure_site_batch as ref_measure
from saguaro_tpu_torch.pipeline.features import FeatureConfig, measure_site, measure_site_batch

from .torch_data import assert_tables_close, blob_sites, share_cpu_threads

share_cpu_threads()

SLICE_OFF = dict(
    measure_texture=False, measure_quantiles=False, measure_radius=False,
    measure_convex=False, measure_neighbors=False, measure_colocalization=False,
    measure_radial=False,
)
KW = dict(channels=("DNA", "GFP", "ER"), max_cells=16, granularity_length=5, **SLICE_OFF)
H, W = 64, 72


@pytest.fixture(scope="module")
def batch():
    img, lab = blob_sites(n_sites=2, h=H, w=W, n_ch=3, n_cells=9, seed=0)
    return img.astype(np.uint16), lab


@pytest.fixture(scope="module")
def ref_tables(batch):
    img, lab = batch
    return ref_measure(img, lab, RefFeatureConfig(**KW), image_numbers=[3, 4],
                       metadata=[{"Metadata_Well": "A01"}, {"Metadata_Well": "A02"}])


def test_measure_site_batch_matches_reference(batch, ref_tables):
    img, lab = batch
    got = measure_site_batch(img, lab, FeatureConfig(**KW), image_numbers=[3, 4],
                             metadata=[{"Metadata_Well": "A01"}, {"Metadata_Well": "A02"}],
                             device="cpu")
    assert len(got) == len(ref_tables) == 2
    for g, r in zip(got, ref_tables):
        assert_tables_close(r, g, H, W)
        assert len(g["Cytoplasm"]) > 0 and len(g["Nuclei"]) == 9
        assert (g["Cells"]["AreaShape_Area"].values >= g["Nuclei"]["AreaShape_Area"].values).all()


def test_measure_site_single_matches_batch(batch):
    img, lab = batch
    cfg = FeatureConfig(**KW)
    one = measure_site(torch.from_numpy(img[1].astype(np.int32)), lab[1], cfg, 7, device="cpu")
    both = measure_site_batch(img, lab, cfg, device="cpu")[1]
    for name in ("Image", "Nuclei", "Cells", "Cytoplasm"):
        a, b = one[name].drop(columns="ImageNumber"), both[name].drop(columns="ImageNumber")
        assert list(a.columns) == list(b.columns)
        np.testing.assert_allclose(a.to_numpy(np.float64), b.to_numpy(np.float64), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("method", ["otsu3", "li"])
def test_other_threshold_methods_and_distance_growth(batch, method):
    img, lab = batch
    kw = dict(KW, secondary_threshold_method=method, secondary_method="distance",
              secondary_iterations=3, measure_moments=False, measure_zernike=False,
              measure_edge=False, granularity_length=2)
    want = ref_measure(img[:1], lab[:1], RefFeatureConfig(**kw))
    got = measure_site_batch(img[:1], lab[:1], FeatureConfig(**kw), device="cpu")
    assert_tables_close(want[0], got[0], H, W)


DEFAULT_CASES = {
    "default": {},
    "centroid": dict(radial_binning="centroid"),
    # the default 50-pixel window exceeds half of this 64 x 72 site
    "adaptive": dict(secondary_threshold_scope="adaptive", secondary_adaptive_window=20),
    "smoothing": dict(secondary_threshold_smoothing=2.0),
}


@pytest.mark.parametrize("case", list(DEFAULT_CASES))
def test_default_config_matches_reference(batch, case):
    img, lab = batch
    kw = dict(channels=("DNA", "GFP", "ER"), max_cells=16, **DEFAULT_CASES[case])
    if case == "adaptive":
        want = [ref_measure_site(img[s], lab[s], RefFeatureConfig(**kw), image_number=s + 1)
                for s in range(len(img))]
    else:
        want = ref_measure(img, lab, RefFeatureConfig(**kw))
    got = measure_site_batch(img, lab, FeatureConfig(**kw), device="cpu")
    for g, r in zip(got, want):
        assert_tables_close(r, g, H, W)
        assert any(c.startswith("Texture_") for c in g["Cells"].columns)
        assert "Metadata_BoundaryCompactionOverflow_Cells" in g["Image"].columns


@pytest.mark.parametrize("case", ["blob channels", "gamma", "flat"])
def test_otsu_threshold_matches_reference(batch, case):
    """The whole-image 256-bin Otsu (not the masked one of the threshold
    module): the same bin, so the same threshold, exactly."""
    from saguaro_tpu.pipeline.features import otsu_threshold as ref_otsu
    from saguaro_tpu_torch.pipeline.features import otsu_threshold

    img, _ = batch
    if case == "blob channels":
        x = np.moveaxis(img, -1, 1).reshape(-1, H, W).astype(np.float32)
    elif case == "gamma":
        x = np.random.default_rng(6).gamma(2.0, 300.0, (6, 37, 41)).astype(np.float32)
    else:
        x = np.full((2, 9, 11), 7.0, np.float32)
    got = otsu_threshold(torch.from_numpy(x)).numpy()
    want = np.array([np.asarray(ref_otsu(x[i])) for i in range(len(x))])
    np.testing.assert_array_equal(got, want)
