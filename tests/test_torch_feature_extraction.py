"""run_feature_extraction_job on a fake plate with a ground-truth
segmenter: the port writes the same 4 CSVs with the same columns and rows
as the reference job, values within ``torch_data.feature_tolerance``; the
per-site failure contract (degrade one site, refuse a systemic failure)
holds."""

import os

import pandas as pd
import pytest

from saguaro_tpu.pipeline.feature_extraction import run_feature_extraction_job as ref_job
from saguaro_tpu.pipeline.features import FeatureConfig as RefFeatureConfig
from saguaro_tpu_torch.pipeline.feature_extraction import (
    SystemicFailureError,
    run_feature_extraction_job,
)
from saguaro_tpu_torch.pipeline.features import FeatureConfig

from .fixtures import make_fake_plate
from .torch_data import assert_tables_close

CHANNELS = ("DNA", "GFP")
KW = dict(
    channels=CHANNELS, max_cells=8, granularity_length=3, measure_texture=False,
    measure_quantiles=False, measure_radius=False, measure_convex=False,
    measure_neighbors=False, measure_colocalization=False, measure_radial=False,
)
SIZE = 48


@pytest.fixture(scope="module")
def plate(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_job"))
    load_data, paths = make_fake_plate(
        root, n_wells=3, image_size=SIZE, channels=CHANNELS, cells_per_site=3,
        cell_radius=5, seed=3,
    )
    return root, load_data, paths


def _segmenter(load_data, paths, poison=()):
    masks = [paths["gt_masks"][(r["Metadata_Well"], r["Metadata_Site"])] for _, r in load_data.iterrows()]
    state = {"i": 0}

    def seg(image):
        i = state["i"]
        state["i"] += 1
        if i in poison:
            raise RuntimeError("segmentation poisoned")
        return masks[i]

    return seg


def _run(job, cfg, plate, out, poison=(), **kw):
    root, load_data, paths = plate
    return job(load_data, os.path.join(root, "Images"), out, list(CHANNELS),
               _segmenter(load_data, paths, poison), feature_cfg=cfg, illum_path=root, **kw)


def test_job_writes_the_reference_tables(plate, tmp_path):
    want = _run(ref_job, RefFeatureConfig(**KW), plate, str(tmp_path / "ref"))
    got = _run(run_feature_extraction_job, FeatureConfig(**KW), plate, str(tmp_path / "port"), device="cpu")
    assert sorted(got) == sorted(want) == ["Cells", "Cytoplasm", "Image", "Nuclei"]
    ref_t = {k: pd.read_csv(v) for k, v in want.items()}
    got_t = {k: pd.read_csv(v) for k, v in got.items()}
    for name in ref_t:
        assert list(got_t[name]["ImageNumber"]) == list(ref_t[name]["ImageNumber"])
    assert_tables_close(ref_t, got_t, SIZE, SIZE)


def test_single_bad_site_degrades(plate, tmp_path):
    got = _run(run_feature_extraction_job, FeatureConfig(**KW), plate, str(tmp_path / "one"),
               poison={1}, device="cpu")
    image = pd.read_csv(got["Image"])
    nuclei = pd.read_csv(got["Nuclei"])
    assert list(image["ImageNumber"]) == [1, 2, 3]
    assert set(nuclei["ImageNumber"]) == {1, 3}


def test_systemic_failure_raises(plate, tmp_path):
    out = str(tmp_path / "all")
    with pytest.raises(SystemicFailureError, match="poisoned"):
        _run(run_feature_extraction_job, FeatureConfig(**KW), plate, out, poison={0, 1, 2}, device="cpu")
    assert not os.path.exists(os.path.join(out, "Nuclei.csv"))
