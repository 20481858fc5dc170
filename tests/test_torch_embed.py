"""The embed half of the engine and ``run_pipeline`` against the reference, on a
tiny config in f32 on both sides, with the same CPnet, EfficientNetV2 and
XGBoost weights: ``embed_sites_pooled``, ``embed_site``,
``process_site_batch`` and ``process_site`` give equal coords and counts
and features within rtol 1e-4, for an empty site, an all-empty batch, a
padded last chunk and ``max_cells`` truncation; extraction sees only
(chunk, box, box) tensors; ``run_pipeline``'s four files match the
reference's, a spill resume computes nothing, a bad file degrades one
site; the CLI keeps its flags and passes ``--devices`` on to the mesh."""

import logging

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from saguaro_tpu.models.cellpose import CellposeConfig as RefCellposeConfig
from saguaro_tpu.models.cellpose import init_cellpose as ref_init_cellpose
from saguaro_tpu.models.effnetv2 import EffNetV2Config as RefEffConfig
from saguaro_tpu.models.effnetv2 import StageSpec as RefStage
from saguaro_tpu.models.effnetv2 import init_effnetv2 as ref_init_effnetv2
from saguaro_tpu.pipeline.segment_embed import SegmentEmbedConfig as RefConfig
from saguaro_tpu.pipeline.segment_embed import SegmentEmbedEngine as RefEngine
from saguaro_tpu.pipeline.segment_embed import run_pipeline as ref_run_pipeline
from saguaro_tpu_torch.models.cellpose import CellposeConfig
from saguaro_tpu_torch.models.effnetv2 import EffNetV2Config, StageSpec
from saguaro_tpu_torch.models.weights import cellpose_state_dict_from_flax, effnet_state_dict_from_flax
from saguaro_tpu_torch.pipeline import segment_embed as se

from .fixtures import make_fake_plate
from .test_torch_cellpose import randomize_bn
from .torch_data import blob_sites, share_cpu_threads, xgb_model_json

share_cpu_threads()

STAGES = (("fused", 1, 3, 1, 4, 1), ("fused", 2, 3, 2, 8, 1), ("mbconv", 2, 3, 2, 8, 2, 0.25))
FEATURES = (8, 16, 32, 64)
CHANNELS = ["DNA", "GFP"]
# the reference's tiny-plate settings: a random CPnet with a louder head
# (see test_torch_segment_embed) finds masks once every pixel is foreground
KW = dict(channels=CHANNELS, diameter=60.0, max_cells=64, min_size=5, cellprob_threshold=-1e9,
          flow_error_threshold=None, box_size=16, embed_chunk=8, embed_size=32, site_batch=4,
          prefetch_workers=2, save_coords=True, single_cell=True,
          xgb_model_path=xgb_model_json(len(CHANNELS) * se.FEATURE_LENGTH, seed=4, base_score=0.4))
CHUNK_SHAPE = (KW["embed_chunk"], KW["box_size"], KW["box_size"])


def _configs():
    ref_eff = RefEffConfig(stem_filters=4, stages=tuple(RefStage(*s) for s in STAGES), head_filters=1280,
                           input_size=32, compute_dtype="float32")
    eff = EffNetV2Config(stem_filters=4, stages=tuple(StageSpec(*s) for s in STAGES), head_filters=1280,
                         input_size=32, compute_dtype="float32")
    ref = RefConfig(**KW, effnet=ref_eff,
                    cellpose=RefCellposeConfig(features=FEATURES, tile=64, compute_dtype="float32"))
    port = se.SegmentEmbedConfig(**KW, effnet=eff,
                                 cellpose=CellposeConfig(features=FEATURES, tile=64, compute_dtype="float32"))
    return ref, port


@pytest.fixture(scope="module")
def engines():
    ref_cfg, cfg = _configs()
    _, cp_vars = ref_init_cellpose(ref_cfg.cellpose, seed=0)
    cp_vars = randomize_bn(cp_vars, 5)
    cp_vars["params"]["output"]["conv"]["kernel"] *= 30.0
    _, en_vars = ref_init_effnetv2(ref_cfg.effnet, seed=0)
    en_vars = randomize_bn(en_vars, 6)
    ref = RefEngine(ref_cfg, cellpose_variables=cp_vars, effnet_variables=en_vars)
    port = se.SegmentEmbedEngine(
        cfg, cellpose_state_dict=cellpose_state_dict_from_flax(cp_vars, cfg.cellpose),
        effnet_state_dict=effnet_state_dict_from_flax(en_vars, cfg.effnet), device="cpu",
    )
    return ref, port


def _highest():
    return jax.default_matmul_precision("highest")


@pytest.fixture(scope="module")
def sites():
    images, labels = blob_sites(n_sites=3, h=64, w=72, n_ch=2, n_cells=9, seed=8)
    return images, labels


def _hold_site(got, want):
    (gf, gc), (wf, wc) = got, want
    assert gf.shape == wf.shape and gc.dtype == np.int64
    np.testing.assert_array_equal(gc, wc)
    np.testing.assert_allclose(gf, wf, rtol=1e-4, atol=1e-6)


def _label_cases(labels):
    empty_one = labels.copy()
    empty_one[1] = 0
    # ids beyond max_cells (64): cells 4-6 of site 0 move to ids 64-66
    trunc = labels.copy()
    for k in (4, 5, 6):
        trunc[0][labels[0] == k] = 60 + k
    return {"batch": labels, "empty_site": empty_one, "all_empty": np.zeros_like(labels),
            "truncated": trunc}


@pytest.mark.parametrize("case", ["batch", "empty_site", "all_empty", "truncated"])
def test_embed_sites_pooled_matches_reference(engines, sites, case):
    ref, port = engines
    images, labels = sites
    labels = _label_cases(labels)[case]
    with _highest():
        want = ref.embed_sites_pooled(images, list(labels))
    got = port.embed_sites_pooled(images, list(labels))
    assert len(got) == len(want) == len(images)
    for g, w in zip(got, want):
        _hold_site(g, w)
    n_slots = sum(len(w[0]) for w in want) * images.shape[-1]
    assert (n_slots == 0) == (case == "all_empty")
    if case == "batch":  # not a multiple of the chunk: the last chunk is padded
        assert n_slots % KW["embed_chunk"] != 0


def test_embed_site_matches_reference(engines, sites):
    ref, port = engines
    images, labels = sites
    with _highest():
        want = ref.embed_site(images[2], labels[2])
    _hold_site(port.embed_site(images[2], labels[2]), want)


def test_extraction_sees_only_chunks(engines, sites, monkeypatch):
    """Crops are cut one chunk at a time: ``gather_crops`` only ever returns
    (embed_chunk, box, box), never the site batch's crop pool."""
    _, port = engines
    images, labels = sites
    shapes = []
    gather = se.gather_crops

    def recording(*args, **kwargs):
        out = gather(*args, **kwargs)
        shapes.append(tuple(out.shape))
        return out

    monkeypatch.setattr(se, "gather_crops", recording)
    got = port.embed_sites_pooled(images, list(labels))
    n_slots = sum(len(f) for f, _ in got) * images.shape[-1]
    assert shapes and set(shapes) == {CHUNK_SHAPE}
    assert len(shapes) == -(-n_slots // KW["embed_chunk"])


def _hold_results(got, want):
    assert got.keys() == want.keys()
    for sid in want:
        g, w = got[sid], want[sid]
        assert g["status"] == w["status"] and g["n_cells"] == w["n_cells"]
        if w["status"] == "success":
            _hold_site((g["features"], g["coords"]), (w["features"], w["coords"]))
            np.testing.assert_array_equal(g["is_dead"], w["is_dead"])
            assert g.get("n_truncated") == w.get("n_truncated")


def test_process_site_batch_matches_reference(engines, sites):
    """Segmentation (the random CPnet) then the pooled embed and dead-cell
    scoring, site ids kept."""
    ref, port = engines
    images = sites[0].astype(np.uint16)
    with _highest():
        want = ref.process_site_batch([7, 3, 9], images)
    got = port.process_site_batch([7, 3, 9], images)
    _hold_results(got, want)
    assert all(r["status"] == "success" for r in want.values())


def test_process_site_matches_reference(engines, sites):
    ref, port = engines
    image = sites[0][0].astype(np.uint16)
    with _highest():
        want = ref.process_site(image)
    _hold_results({0: port.process_site(image)}, {0: want})
    assert want["status"] == "success"


def test_pooled_failure_degrades_per_site(engines, sites, monkeypatch, caplog):
    """A failed pooled embed (here: of more than one site) falls back to
    embedding site by site, and a site that still fails comes back empty;
    each degrade is logged at ERROR."""
    _, port = engines
    images = sites[0].astype(np.uint16)
    want = port.process_site_batch([0, 1], images[:2])
    pooled = port.embed_sites_pooled

    def fails_on_batches_and_site_1(images_, labels_list):
        if len(labels_list) > 1:
            raise RuntimeError("out of memory")
        if torch.equal(torch.as_tensor(images_[0]).float(), torch.as_tensor(images[1]).float()):
            raise RuntimeError("bad site")
        return pooled(images_, labels_list)

    monkeypatch.setattr(port, "embed_sites_pooled", fails_on_batches_and_site_1)
    with caplog.at_level(logging.ERROR, logger="saguaro_tpu_torch.segment_embed"):
        got = port.process_site_batch([0, 1], images[:2])
    assert got[1] == {"status": "empty", "n_cells": 0}
    _hold_results({0: got[0]}, {0: want[0]})
    assert [r.getMessage() for r in caplog.records] == [
        "pooled embed failed (out of memory); falling back per-site", "embed failed: bad site"]


# ---------------------------------------------------------------------------
# run_pipeline and the CLI


@pytest.fixture(scope="module")
def plate(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("plate"))
    return make_fake_plate(root, n_wells=3, sites_per_well=1, image_size=96, cells_per_site=6,
                           cell_radius=6, seed=2)


def _read_outputs(outputs):
    out = {"counts": pd.read_csv(outputs["counts"])}
    for kind in ("coords", "well_aggregated", "single_cell"):
        out[kind] = pd.read_parquet(outputs[kind])
    return out


def _hold_frames(got, want):
    assert list(got.columns) == list(want.columns) and len(got) == len(want)
    for col in want.columns:
        if col in ("mean_features", "single_cell_features"):
            g = np.stack([np.stack(np.asarray(v).tolist()).astype(np.float64).ravel() for v in got[col]])
            w = np.stack([np.stack(np.asarray(v).tolist()).astype(np.float64).ravel() for v in want[col]])
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)
        else:
            pd.testing.assert_series_equal(got[col], want[col])


@pytest.fixture(scope="module")
def driven(engines, plate, tmp_path_factory):
    ref, port = engines
    load_data, paths = plate
    out = tmp_path_factory.mktemp("out")
    illum = [np.full((96, 96), 1.25, np.float32), None]
    with _highest():
        want = ref_run_pipeline(load_data, paths["images"], ref.cfg, str(out / "ref.parquet"),
                                engine=ref, illum=illum)
    spill = str(out / "spill")
    got = se.run_pipeline(load_data, paths["images"], port.cfg, str(out / "port.parquet"),
                          engine=port, illum=illum, spill_dir=spill)
    return want, got, spill


def test_run_pipeline_matches_reference(driven):
    """Counts CSV, coords, well-aggregated and single-cell parquet files:
    the same names (but for the prefix), columns and values."""
    want, got, _ = driven
    assert sorted(want) == sorted(got) == ["coords", "counts", "single_cell", "well_aggregated"]
    for kind in want:
        assert got[kind].split("port")[-1] == want[kind].split("ref")[-1]
    w, g = _read_outputs(want), _read_outputs(got)
    for kind in w:
        _hold_frames(g[kind], w[kind])
    assert (w["counts"]["Cell_Count"] > 0).all() and "Dead_Cells" in w["counts"].columns


def test_spill_resume_computes_nothing(engines, plate, driven, monkeypatch, tmp_path):
    _, port = engines
    load_data, paths = plate
    _, first, spill = driven

    def no_compute(*a, **k):
        raise AssertionError("a resumed run computed a site batch")

    monkeypatch.setattr(port, "process_site_batch", no_compute)
    again = se.run_pipeline(load_data, paths["images"], port.cfg, str(tmp_path / "port.parquet"),
                            engine=port, spill_dir=spill)
    a, b = _read_outputs(again), _read_outputs(first)
    for kind in a:
        _hold_frames(a[kind], b[kind])


def test_bad_file_degrades_one_site(engines, plate, tmp_path, caplog):
    _, port = engines
    load_data, paths = plate
    bad = load_data.copy()
    bad.loc[1, "FileName_GFP"] = "does_not_exist.tiff"
    with caplog.at_level(logging.ERROR, logger="saguaro_tpu_torch.segment_embed"):
        out = se.run_pipeline(bad, paths["images"], port.cfg, str(tmp_path / "bad.parquet"), engine=port)
    counts = pd.read_csv(out["counts"])["Cell_Count"].tolist()
    assert counts[1] == 0 and counts[0] > 0 and counts[2] > 0
    assert any("prefetch failed on site 1" in r.getMessage() for r in caplog.records)


def test_cli_keeps_the_reference_flags(capsys):
    from saguaro_tpu_torch.cli.segment_embed import main

    with pytest.raises(SystemExit) as exc:
        main(["--help"])
    assert exc.value.code == 0
    text = capsys.readouterr().out
    for flag in ("--bucket_input", "--data_base_path", "--num_consumers", "--max_workers",
                 "--load_data_key", "--csv_image_key", "--channels", "--out_data_path",
                 "--single_cell", "--save_coords", "--xgb_model_path", "--filter_dead_cells",
                 "--diameter", "--max_cells", "--cellpose_checkpoint", "--effnet_checkpoint",
                 "--spill_dir", "--devices", "--device"):
        assert flag in text


@pytest.mark.parametrize("devices", ["2", "8"])
def test_cli_passes_devices_to_the_mesh(devices, tmp_path, monkeypatch):
    """``--devices`` reaches ``SegmentEmbedConfig.devices``, the mesh size
    ``run_pipeline`` builds its default engine's mesh from."""
    from saguaro_tpu_torch.cli.segment_embed import main

    pd.DataFrame({"Metadata_Well": ["A01"]}).to_csv(tmp_path / "k.csv", index=False)
    seen = []
    monkeypatch.setattr(se, "run_pipeline", lambda load_data, base, cfg, out, **kw: seen.append(cfg)
                        or {})
    argv = ["--bucket_input", str(tmp_path), "--data_base_path", "d", "--load_data_key", "k.csv",
            "--channels", "DNA", "--out_data_path", "o.parquet", "--devices", devices]
    main(argv)
    assert [c.devices for c in seen] == [int(devices)]
