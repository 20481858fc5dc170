"""``parallel.mesh`` and the sharded paths, on a mesh of eight ``cpu``
entries (the reference's eight CPU devices, ``tests/test_mesh.py``): each
case of the reference's file has its counterpart here. A sharded run is
held against the same call unsharded: labels, crops and counts equal,
features and tables to the reference file's tolerances (a shard is a
smaller batch, whose f32 sums may round in another order)."""

import numpy as np
import pandas as pd
import pytest
import torch

from saguaro_tpu_torch.models.cellpose import CellposeConfig
from saguaro_tpu_torch.models.effnetv2 import EffNetV2Config, StageSpec
from saguaro_tpu_torch.parallel import mesh as pm
from saguaro_tpu_torch.parallel.mesh import (
    default_mesh,
    fsdp_param_sharding,
    make_mesh,
    replicate,
    shard_batch,
)
from saguaro_tpu_torch.pipeline import segment_embed as se

from .fixtures import make_fake_plate
from .torch_data import share_cpu_threads

share_cpu_threads()

CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module")
def mesh8():
    return make_mesh(devices=CPU8)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _engine_cfg(box=32, max_cells=16, chunk=8, size=64, **kw):
    return se.SegmentEmbedConfig(
        channels=["DNA", "GFP"], diameter=None, box_size=box, max_cells=max_cells,
        embed_chunk=chunk, embed_size=size, flow_iters=30, min_size=3,
        cellprob_threshold=-1e9, flow_error_threshold=None,
        cellpose=CellposeConfig(tile=64, features=(4, 8, 16, 32), compute_dtype="float32"),
        effnet=EffNetV2Config(stem_filters=4, stages=(StageSpec("fused", 1, 3, 1, 4, 1),),
                              head_filters=1280, input_size=size, compute_dtype="float32"),
        **kw,
    )


def _louder_cpnet(cfg) -> dict:
    """The seeded CPnet with its output convolution 30x louder: a random
    network's flows then gather every foreground pixel into masks (as in
    ``test_torch_embed``)."""
    from saguaro_tpu_torch.models.cellpose import init_cellpose

    state = init_cellpose(cfg.cellpose, seed=0, device="cpu").state_dict()
    state["output.2.weight"] = state["output.2.weight"] * 30.0
    return state


def _engines(cfg, mesh):
    state = _louder_cpnet(cfg)
    single = se.SegmentEmbedEngine(cfg, cellpose_state_dict=state, seed=0, device="cpu")
    sharded = se.SegmentEmbedEngine(cfg, cellpose_state_dict=state, seed=0, mesh=mesh)
    return single, sharded


# ---------------------------------------------------------------------------
# the primitives


def test_mesh_layout():
    m = make_mesh(devices=CPU8, model=2)
    assert m.shape == {"data": 4, "model": 2} and m.size == 8
    assert m.axis_names == ("data", "model") and len(m.data_devices) == 4
    with pytest.raises(ValueError):
        make_mesh(devices=CPU8, data=3)
    with pytest.raises(ValueError):
        make_mesh(9, devices=CPU8)


def test_shard_batch_layout(mesh8, rng):
    x = rng.normal(size=(16, 32, 32)).astype(np.float32)
    sharded = shard_batch(x, mesh8)
    assert len(sharded.shards) == 8 and len(sharded.devices) == 8
    assert all(s.shape == (2, 32, 32) for s in sharded.shards)
    assert len(sharded) == 16 and sharded.shape == (16, 32, 32)
    np.testing.assert_array_equal(sharded.gather().numpy(), x)
    with pytest.raises(ValueError, match="evenly"):
        shard_batch(x[:12], mesh8)


def test_replicate(mesh8, rng):
    tree = {"w": rng.normal(size=(8, 8)).astype(np.float32)}
    reps = replicate(tree, mesh8)
    assert len(reps) == 8
    for r in reps:
        np.testing.assert_array_equal(r["w"].numpy(), tree["w"])
    assert len({r["w"].data_ptr() for r in reps}) == 8  # one copy a device
    module = torch.nn.Linear(4, 3)
    mods = replicate(module, mesh8)
    assert mods[0] is module and all(m is not module for m in mods[1:])
    for m in mods[1:]:
        torch.testing.assert_close(m.weight, module.weight, rtol=0, atol=0)


def test_fsdp_sharding_splits_large(rng):
    mesh = make_mesh(8, model=2, devices=CPU8)
    tree = {
        "big": rng.normal(size=(256, 512)).astype(np.float32),
        "small": rng.normal(size=(4,)).astype(np.float32),
    }
    out = fsdp_param_sharding(tree, mesh, min_size=1024)
    assert not out["big"].is_fully_replicated and out["big"].dim == 1
    assert [tuple(s.shape) for s in out["big"].shards] == [(256, 256)] * 2
    assert out["small"].is_fully_replicated
    np.testing.assert_array_equal(out["big"].gather().numpy(), tree["big"])
    assert all(p.is_fully_replicated for p in fsdp_param_sharding(tree, make_mesh(devices=CPU8),
                                                                  min_size=1024).values())


def test_sharded_computation_matches_single(mesh8, rng):
    from saguaro_tpu_torch.kernels.qc import qc_metrics_batch

    imgs = rng.integers(0, 4095, (8, 96, 96)).astype(np.float32)
    ref_slopes, ref_pcts = (a.numpy() for a in qc_metrics_batch(torch.from_numpy(imgs)))
    parts = [qc_metrics_batch(s) for s in shard_batch(imgs, mesh8).shards]
    s_slopes = torch.cat([p[0] for p in parts]).numpy()
    s_pcts = torch.cat([p[1] for p in parts]).numpy()
    np.testing.assert_allclose(s_slopes, ref_slopes, rtol=1e-5)
    np.testing.assert_allclose(s_pcts, ref_pcts, rtol=1e-6)


# ---------------------------------------------------------------------------
# the engine and the measurement


@pytest.mark.parametrize("n_sites", [8, 3], ids=["even", "uneven_pads"])
def test_segment_batch_sharded_matches_unsharded(mesh8, rng, n_sites):
    """A partial batch (3 sites on the 8-way mesh) is padded with blank
    sites and the padding dropped."""
    single, sharded = _engines(_engine_cfg(), mesh8)
    batch = rng.integers(0, 4000, (n_sites, 64, 64, 2)).astype(np.uint16)
    a = [x.numpy() for x in single.segment_batch(batch)]
    b = [x.numpy() for x in sharded.segment_batch(batch)]
    assert len(a) == len(b) == n_sites
    assert sum(int(x.max()) for x in a) > 0
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def _measure_inputs(rng, b=8, h=48, w=48):
    images = (rng.random((b, h, w, 2)) * 100).astype(np.float32)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    nuclei = np.zeros((b, h, w), np.int32)
    for i in range(b):
        nuclei[i][(yy - 16 - i) ** 2 + (xx - 24) ** 2 <= 25] = 1
    return images, nuclei


def _measure_cfg():
    from saguaro_tpu_torch.pipeline.features import FeatureConfig

    return FeatureConfig(channels=("DNA", "GFP"), max_cells=8, glcm_levels=8,
                         secondary_iterations=4, granularity_length=4, measure_zernike=False,
                         max_radius=8, convex_dirs=12)


def _hold_tables(plain, sharded):
    assert len(plain) == len(sharded)
    for p, s in zip(plain, sharded):
        for name in ("Image", "Nuclei", "Cells", "Cytoplasm"):
            # atol 2e-6: the granularity tail elements are differences of
            # f32 means, as in the reference's sharded check
            pd.testing.assert_frame_equal(p[name], s[name], rtol=1e-5, atol=2e-6)


def test_measurement_sharded_matches_unsharded(mesh8, rng):
    from saguaro_tpu_torch.pipeline.features import measure_site_batch

    images, nuclei = _measure_inputs(rng)
    plain = measure_site_batch(images, nuclei, _measure_cfg(), device="cpu")
    sharded = measure_site_batch(images, nuclei, _measure_cfg(), mesh=mesh8)
    _hold_tables(plain, sharded)


def test_measurement_sharded_dispatch(rng):
    """The dispatch path sharded (the reference's counterpart runs the
    Pallas dispatch inside shard_map): one packed buffer set a shard, joined
    in site order at finalize; a batch the data axis does not divide runs
    unsharded."""
    from saguaro_tpu_torch.pipeline.features import (
        measure_site_batch,
        measure_site_batch_dispatch,
        measure_site_batch_finalize,
    )

    images, nuclei = _measure_inputs(rng, b=4)
    cfg = _measure_cfg()
    plain = measure_site_batch(images, nuclei, cfg, image_numbers=[5, 6, 7, 8], device="cpu")
    handle = measure_site_batch_dispatch(images, nuclei, cfg, mesh=make_mesh(devices=["cpu"] * 2))
    assert len(handle.shards) == 2 and all(h.n_sites == 2 for h in handle.shards)
    assert all(set(h.buffers) == {torch.float32, torch.int32} for h in handle.shards)
    _hold_tables(plain, measure_site_batch_finalize(handle, image_numbers=[5, 6, 7, 8]))
    uneven = measure_site_batch_dispatch(images[:3], nuclei[:3], cfg, device="cpu",
                                         mesh=make_mesh(devices=["cpu"] * 2))
    assert not uneven.shards and uneven.n_sites == 3


def test_pooled_embed_sharded_matches_per_site(mesh8, rng):
    """Crops sharded over the data axis: the pooled embeddings equal the
    per-site unsharded ones."""
    single, sharded = _engines(_engine_cfg(box=16, max_cells=8, chunk=4, size=32), mesh8)
    b, h, w = 4, 64, 64
    images = rng.random((b, h, w, 2)).astype(np.float32)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    labels = np.zeros((b, h, w), np.int32)
    centers = [[(20, 20), (40, 44)], [(32, 32)], [], [(16, 48), (48, 16), (32, 32)]]
    for i, cs in enumerate(centers):
        for k, (cy, cx) in enumerate(cs, start=1):
            labels[i][(yy - cy) ** 2 + (xx - cx) ** 2 <= 36] = k
    want = [single.embed_site(images[i], labels[i]) for i in range(b)]
    got_sharded = sharded.embed_sites_pooled(images, list(labels))
    got_pooled = single.embed_sites_pooled(images, list(labels))
    for (wf, wc), (sf, sc), (pf, pc) in zip(want, got_sharded, got_pooled):
        assert wf.shape == sf.shape == pf.shape
        np.testing.assert_array_equal(wc, sc)
        np.testing.assert_array_equal(wc, pc)
        np.testing.assert_allclose(sf, wf, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(pf, wf, rtol=1e-5, atol=1e-5)
    assert len(got_sharded[2][0]) == 0  # the empty site stays empty


# ---------------------------------------------------------------------------
# the production default


def test_default_mesh_helper(monkeypatch):
    assert default_mesh() is None  # no CUDA device here
    monkeypatch.setattr(pm, "visible_devices", lambda: [torch.device("cpu")] * 8)
    m = default_mesh()
    assert m is not None and m.size == 8 and m.shape == {"data": 8, "model": 1}
    assert default_mesh(1) is None
    assert default_mesh(4).size == 4


@pytest.mark.parametrize("device,n,size", [
    (None, None, 8), ("cuda", None, 8), ("cuda", 3, 3), (None, 1, None), ("cpu", None, None),
    ("cuda:1", None, None), (torch.device("cpu"), 1, None)])
def test_default_mesh_for_a_named_device(monkeypatch, device, n, size):
    """The entry points' automatic mesh: over the visible devices (8
    entries, patched) only where the caller names no device or CUDA
    without an index; a named CPU or a pinned card gets none."""
    monkeypatch.setattr(pm, "visible_devices", lambda: [torch.device("cpu")] * 8)
    m = pm.default_mesh_for(device, n)
    assert (m is None) if size is None else m.size == size


@pytest.mark.parametrize("device", ["cpu", "cuda:0"])
def test_default_mesh_for_refuses_several_devices_on_one(monkeypatch, device):
    monkeypatch.setattr(pm, "visible_devices", lambda: [torch.device("cpu")] * 8)
    with pytest.raises(ValueError, match="mesh of 4 devices"):
        pm.default_mesh_for(device, 4)


def test_run_pipeline_builds_meshed_engine_and_matches(tmp_path, monkeypatch):
    """With no engine and several visible devices, run_pipeline hands its
    engine a mesh over all of them; the outputs equal a single-device
    run's."""
    load_data, paths = make_fake_plate(str(tmp_path / "plate"), n_wells=3, sites_per_well=1,
                                       image_size=96)
    cfg = _engine_cfg(box=40, max_cells=32, size=64, prefetch_workers=2, site_batch=3)
    monkeypatch.setattr(pm, "visible_devices", lambda: [torch.device("cpu")] * 8)
    seen = []
    real_engine = se.SegmentEmbedEngine

    state = _louder_cpnet(cfg)

    class CapturingEngine(real_engine):
        def __init__(self, cfg, *args, **kwargs):
            seen.append(kwargs.get("mesh"))
            super().__init__(cfg, *args, cellpose_state_dict=state, **kwargs)

    monkeypatch.setattr(se, "SegmentEmbedEngine", CapturingEngine)
    out_mesh = se.run_pipeline(load_data, paths["images"], cfg, str(tmp_path / "meshed.parquet"))
    assert len(seen) == 1 and seen[0] is not None and seen[0].size == 8
    single = real_engine(cfg, cellpose_state_dict=state, seed=0, device="cpu")
    out_single = se.run_pipeline(load_data, paths["images"], cfg, str(tmp_path / "single.parquet"),
                                 engine=single)
    counts_m, counts_s = pd.read_csv(out_mesh["counts"]), pd.read_csv(out_single["counts"])
    pd.testing.assert_frame_equal(counts_m, counts_s)
    assert counts_s["Cell_Count"].sum() > 0
    agg_m = pd.read_parquet(out_mesh["well_aggregated"])
    agg_s = pd.read_parquet(out_single["well_aggregated"])
    assert (agg_m["Metadata_Well"] == agg_s["Metadata_Well"]).all()
    for a, b in zip(agg_m["mean_features"], agg_s["mean_features"]):
        np.testing.assert_allclose(np.stack([np.asarray(x) for x in a]),
                                   np.stack([np.asarray(x) for x in b]), rtol=1e-4, atol=1e-4)
