"""run_feature_extraction_job on a fake plate with a ground-truth
segmenter: the port writes the same 4 CSVs with the same columns and rows
as the reference job, values within ``torch_data.feature_tolerance``; the
per-site failure contract (degrade one site, refuse a systemic failure)
holds, and a batch whose finalize fails degrades alone. The job grid
(``run_batch_processing``) writes the reference's CSVs for every (plate,
time) job, resumes from its manifest and takes its process's stride;
``measure_site_batch_dispatch`` + ``finalize`` equal ``measure_site_batch``
(integer columns bit-equal)."""

import hashlib
import os

import numpy as np
import pandas as pd
import pytest
import torch

from saguaro_tpu.pipeline.feature_extraction import run_batch_processing as ref_grid
from saguaro_tpu.pipeline.feature_extraction import run_feature_extraction_job as ref_job
from saguaro_tpu.pipeline.features import FeatureConfig as RefFeatureConfig
from saguaro_tpu_torch.io import tiff
from saguaro_tpu_torch.parallel import distributed
from saguaro_tpu_torch.pipeline import feature_extraction as fe
from saguaro_tpu_torch.pipeline.feature_extraction import (
    SystemicFailureError,
    run_batch_processing,
    run_feature_extraction_job,
)
from saguaro_tpu_torch.pipeline.features import (
    FeatureConfig,
    measure_site_batch,
    measure_site_batch_dispatch,
    measure_site_batch_finalize,
)

from .fixtures import make_fake_plate
from .torch_data import assert_tables_close, blob_sites, share_cpu_threads

share_cpu_threads()

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


def test_failed_finalize_degrades_only_its_batch(plate, tmp_path, monkeypatch):
    """With ``site_batch=2`` the 3 sites are two batches; the first batch's
    finalize raises, so its sites are measured one by one and every site
    still gets its tables, equal to an undisturbed run's."""
    calls = []
    real = fe.measure_site_batch_finalize

    def flaky(handle, image_numbers=None, metadata=None):
        calls.append(list(image_numbers))
        if len(calls) == 1:
            raise RuntimeError("fetch failed")
        return real(handle, image_numbers, metadata)

    want = _run(run_feature_extraction_job, FeatureConfig(**KW), plate, str(tmp_path / "ok"),
                site_batch=2, device="cpu")
    monkeypatch.setattr(fe, "measure_site_batch_finalize", flaky)
    got = _run(run_feature_extraction_job, FeatureConfig(**KW), plate, str(tmp_path / "flaky"),
               site_batch=2, device="cpu")
    assert calls == [[1, 2], [3]]
    for name in want:
        pd.testing.assert_frame_equal(pd.read_csv(got[name]), pd.read_csv(want[name]))


def test_dispatch_finalize_equals_measure_site_batch():
    img, lab = blob_sites(n_sites=2, h=40, w=44, n_ch=2, n_cells=5, seed=4)
    cfg = FeatureConfig(**KW)
    want = measure_site_batch(img, lab, cfg, image_numbers=[3, 4], device="cpu")
    handle = measure_site_batch_dispatch(img, lab, cfg, device="cpu")
    assert set(handle.buffers) == {torch.float32, torch.int32} and handle.ready is None
    got = measure_site_batch_finalize(handle, image_numbers=[3, 4])
    for g, w in zip(got, want):
        for name in w:
            ints = [c for c in w[name].columns if pd.api.types.is_integer_dtype(w[name][c])]
            assert ints and [c for c in g[name].columns if c in ints] == ints
            pd.testing.assert_frame_equal(g[name], w[name], check_exact=True)


GRID_PLATES, GRID_TIMES = ["P1", "P2"], ["6", "24"]


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    """2 plates x 2 times, 3 sites a job, under ``<root>/<plate>_<time>/``:
    each job has images of its own seed, so a job fed another job's inputs
    writes other tables; the segmenter returns each site's ground-truth
    mask, found by the image's content."""
    root = str(tmp_path_factory.mktemp("torch_grid"))
    masks = {}
    for seed, (p, t) in enumerate((p, t) for p in GRID_PLATES for t in GRID_TIMES):
        job = os.path.join(root, f"{p}_{t}")
        os.makedirs(job)
        load_data, paths = make_fake_plate(job, n_wells=3, image_size=SIZE, channels=CHANNELS,
                                           cells_per_site=3, cell_radius=5, timepoint=t,
                                           plate=p, seed=10 + seed)
        for _, r in load_data.iterrows():
            dna = np.asarray(tiff.imread(os.path.join(paths["images"], r["FileName_DNA"])))
            masks[hashlib.sha1(dna.astype(np.float32).tobytes()).hexdigest()] = (
                paths["gt_masks"][(r["Metadata_Well"], r["Metadata_Site"])])

    def segmenter(image):
        key = hashlib.sha1(np.ascontiguousarray(image[..., 0], np.float32).tobytes()).hexdigest()
        return masks[key]

    return root, segmenter


def _grid_kw(grid, out):
    root, segmenter = grid
    return dict(bucket_name=root, base_output_path=out, plates=GRID_PLATES, times=GRID_TIMES,
                channels=list(CHANNELS), image_path_for_job=lambda p, t: f"{p}_{t}/Images",
                load_data_key_for_job=lambda p, t: f"{p}_{t}/load_data.csv", segmenter=segmenter)


def test_grid_writes_the_reference_tables_and_resumes(grid, tmp_path):
    want = ref_grid(**_grid_kw(grid, str(tmp_path / "ref")), feature_cfg=RefFeatureConfig(**KW),
                    mesh=None)
    out = str(tmp_path / "port")
    got = run_batch_processing(**_grid_kw(grid, out), feature_cfg=FeatureConfig(**KW),
                               site_batch=2, device="cpu")
    assert list(got) == list(want) == [(p, t) for p in GRID_PLATES for t in GRID_TIMES]
    for job, files in want.items():
        assert got[job] == {k: v.replace(str(tmp_path / "ref"), out) for k, v in files.items()}
        ref_t = {k: pd.read_csv(v) for k, v in files.items()}
        got_t = {k: pd.read_csv(v) for k, v in got[job].items()}
        # the fixture's cells are disks, whose third-order Hu moments are 0:
        # both sides hold rounding noise there (reference -0.0, port -1.9e-13)
        assert_tables_close(ref_t, got_t, SIZE, SIZE, hu_floor=1e-10)
        assert len(got_t["Image"]) == 3 and len(got_t["Nuclei"]) > 0
        for name, table in got_t.items():
            assert set(table["Metadata_Plate"]) <= {job[0]}, name
            assert set(table["Metadata_Timepoint"].astype(str)) <= {job[1]}, name
        assert set(got_t["Nuclei"]["Metadata_Plate"]) == {job[0]}
        assert set(got_t["Nuclei"]["Metadata_Timepoint"].astype(str)) == {job[1]}
    manifest = pd.read_json(os.path.join(out, "manifest.jsonl"), lines=True)
    assert manifest["unit"].tolist() == [f"{p}/{t}" for p in GRID_PLATES for t in GRID_TIMES]
    # the resume skips every done job and writes nothing
    stamp = {f: os.path.getmtime(f) for files in got.values() for f in files.values()}
    again = run_batch_processing(**_grid_kw(grid, out), feature_cfg=FeatureConfig(**KW),
                                 site_batch=2, device="cpu")
    assert again == {} and {f: os.path.getmtime(f) for f in stamp} == stamp
    assert len(pd.read_json(os.path.join(out, "manifest.jsonl"), lines=True)) == 4


def test_grid_takes_its_process_stride(grid, tmp_path, monkeypatch):
    monkeypatch.setattr(distributed, "process_info", lambda: (1, 3))
    assert distributed.partition_jobs(list(range(8))) == [1, 4, 7]
    assert distributed.partition_jobs(list(range(8)), 0, 2) == [0, 2, 4, 6]
    got = run_batch_processing(**_grid_kw(grid, str(tmp_path / "stride")),
                               feature_cfg=FeatureConfig(**KW), device="cpu")
    assert sorted(got) == [("P1", "24")]


def test_process_info_reads_the_process_group(tmp_path):
    import torch.distributed as dist

    assert distributed.process_info() == (0, 1)
    distributed.maybe_initialize()
    assert not dist.is_initialized()
    distributed.maybe_initialize(f"file://{tmp_path / 'rendezvous'}", num_processes=1, process_id=0)
    try:
        assert dist.is_initialized() and distributed.process_info() == (0, 1)
        distributed.maybe_initialize(f"file://{tmp_path / 'other'}", num_processes=1)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("devices", [2, 3])
def test_grid_measures_sharded_over_a_mesh(grid, tmp_path, devices):
    """With a mesh the job grid's batches of ``devices`` sites are measured
    sharded over it (a shorter last batch unsharded); the tables equal the
    one-device run's to the reference's sharded tolerance (rtol 1e-5, atol
    2e-6: a shard's f32 means sum in another order)."""
    from saguaro_tpu_torch.parallel.mesh import make_mesh

    kw = dict(feature_cfg=FeatureConfig(**KW), site_batch=devices, device="cpu", resume=False)
    want = run_batch_processing(**_grid_kw(grid, str(tmp_path / "one")), mesh=None, **kw)
    got = run_batch_processing(**_grid_kw(grid, str(tmp_path / "multi")),
                               mesh=make_mesh(devices=["cpu"] * devices), **kw)
    assert list(got) == list(want)
    for job, files in want.items():
        for name, path in files.items():
            pd.testing.assert_frame_equal(pd.read_csv(got[job][name]), pd.read_csv(path),
                                          rtol=1e-5, atol=2e-6)


@pytest.mark.parametrize("device,mesh,size", [
    ("cpu", "default", None), ("cpu", "auto", None), (None, "default", None), (None, "auto", 8)])
def test_grid_shards_measurement_only_when_asked(grid, tmp_path, monkeypatch, device, mesh, size):
    """With eight devices visible (patched) the job grid measures on one
    device unless ``mesh="auto"`` asks for the visible cards, and not then
    either when ``device`` names the CPU."""
    from saguaro_tpu_torch.parallel import mesh as pm

    monkeypatch.setattr(pm, "visible_devices", lambda: [torch.device("cpu")] * 8)
    monkeypatch.setattr(fe, "resolve_device", lambda d: torch.device("cpu"))
    seen = []
    monkeypatch.setattr(fe, "run_feature_extraction_job",
                        lambda *a, **kw: seen.append(kw["mesh"]) or {})
    kw = dict(device=device) if mesh == "default" else dict(device=device, mesh=mesh)
    run_batch_processing(**_grid_kw(grid, str(tmp_path)), resume=False, **kw)
    assert len(seen) == len(GRID_PLATES) * len(GRID_TIMES)
    assert all((m is None) if size is None else m.size == size for m in seen)


def test_distinct_errors_do_not_trip_systemic(grid, tmp_path):
    """Two of a job's three sites failing with DIFFERENT errors is not
    systemic: the detector keys on the most common identical exception
    (the reference's ``tests/test_failure_contract.py`` case, through the
    job grid). Every job still writes a row a site; the same error on those
    two sites does raise."""
    root, segmenter = grid
    calls = {"n": 0}

    def flaky(distinct):
        def seg(image):
            i = calls["n"]
            calls["n"] += 1
            if i % 3 != 1:  # the first and third site of each job
                raise RuntimeError(f"flaky read {i}" if distinct else "flaky read")
            return segmenter(image)
        return seg

    kw = _grid_kw(grid, str(tmp_path / "distinct"))
    kw["segmenter"] = flaky(True)
    got = run_batch_processing(**kw, feature_cfg=FeatureConfig(**KW), device="cpu", mesh=None)
    assert len(got) == len(GRID_PLATES) * len(GRID_TIMES)
    for files in got.values():
        image = pd.read_csv(files["Image"])
        assert list(image["ImageNumber"]) == [1, 2, 3]
        assert set(pd.read_csv(files["Nuclei"])["ImageNumber"]) == {2}
    calls["n"] = 0
    kw = _grid_kw(grid, str(tmp_path / "same"))
    kw["segmenter"] = flaky(False)
    with pytest.raises(SystemicFailureError, match="flaky read"):
        run_batch_processing(**kw, feature_cfg=FeatureConfig(**KW), device="cpu", mesh=None)


def test_tables_keep_the_reference_column_order(plate, tmp_path):
    """Each table's columns in the reference's order (feature names sorted,
    as its result tree comes back through JAX), so that the profile stages
    write the reference's column order too."""
    want = _run(ref_job, RefFeatureConfig(**KW), plate, str(tmp_path / "ref"))
    got = _run(run_feature_extraction_job, FeatureConfig(**KW), plate, str(tmp_path / "port"),
               device="cpu")
    for name, path in want.items():
        ref_cols = list(pd.read_csv(path, nrows=0).columns)
        assert list(pd.read_csv(got[name], nrows=0).columns) == ref_cols, name
        features = [c for c in ref_cols if c not in ("ImageNumber", "ObjectNumber")
                    and not c.startswith(("Metadata_", "Parent_", "Number_"))]
        if name != "Image":  # the Image table expands each granularity spectrum in place
            assert features == sorted(features) and len(features) > 10, name
