"""chip_smoke.py without a card: it exits non-zero and prints no result,
in the repository and in a directory holding nothing else; its main path
(engine -> mask recovery -> measurement), its job grid (two jobs and the
resume), its profile phase (on the grid's CSVs and a 24-well plate), its
TIFF phase, its single-site phase (engine segment, Euler recovery held
against the ground truth and the CPU) and its pixel path (max projection
-> re-binning -> illumination estimate -> QC) rehearse on the CPU at a
small size through the plain forms; and ``--profile``'s reading of a
trace by ``measure/<family>`` range holds on synthetic events."""

import importlib.util
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from .torch_data import share_cpu_threads

share_cpu_threads()

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(cwd):
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True, text=True,
                         timeout=300)
    for line in res.stdout.splitlines():
        if line.startswith("{"):
            assert not json.loads(line).get("ok"), line
    return res.returncode


def test_refuses_without_a_card():
    assert _run(ROOT) != 0


def test_refuses_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    assert _run(tmp_path) != 0


def test_main_path_rehearsal_on_cpu(smoke):
    images, gt = smoke.synthetic_sites(2, 200, seed=3)
    assert images.dtype == np.uint16 and int(gt[0].max()) == 4
    tables, rec, secs = smoke.run_main_path(images, gt, "cpu")
    smoke.check_recovery(rec, gt)
    smoke.check_tables(tables, 4)
    assert set(secs) == {"segment", "recover", "measure"}
    assert (tables[0]["Cells"]["AreaShape_Area"].values > tables[0]["Nuclei"]["AreaShape_Area"].values).all()


def test_single_site_rehearsal_on_cpu(smoke):
    images, gt = smoke.synthetic_sites(2, 200, seed=6)
    secs = smoke.run_single_site(images, gt, "cpu", crop=100)
    assert set(secs) == {"segment", "recover_euler"} and all(v > 0 for v in secs.values())


def test_small_batch_check_rehearsal_on_cpu(smoke):
    smoke.check_small_against_cpu("cpu")


@pytest.fixture(scope="module")
def grid_root(smoke, tmp_path_factory):
    """The job grid phase at 2 sites of 200² a job, two jobs, with the
    resume; its engine has a tiny EfficientNet (the phase only segments)."""
    from saguaro_tpu_torch.models.cellpose import CellposeConfig
    from saguaro_tpu_torch.models.effnetv2 import EffNetV2Config, StageSpec
    from saguaro_tpu_torch.pipeline.segment_embed import SegmentEmbedConfig, SegmentEmbedEngine

    tiny = EffNetV2Config(stem_filters=4, stages=(StageSpec("fused", 1, 3, 1, 4, 1),), head_filters=8)
    engine = SegmentEmbedEngine(SegmentEmbedConfig(channels=list(smoke.CHANNELS), effnet=tiny),
                                cellpose_state_dict=smoke.gradient_cpnet(CellposeConfig()), device="cpu")
    root = str(tmp_path_factory.mktemp("grid"))
    return root, smoke.run_grid(root, "cpu", n_sites=2, size=200, engine=engine)


def test_job_rehearsal_on_cpu(grid_root):
    """The job grid phase: two jobs of 2 sites of 200², every placed nucleus
    found, no site failure, a resume that runs nothing; the split of its
    wall time names every stage, and the native decoder took every file."""
    _, got = grid_root
    assert got["files"] == got["native_files"] == 2 * 2 * 5
    assert {"read", "segment", "dispatch", "finalize", "write", "other"} <= set(got["split_s"])
    assert got["sites_per_s"] > 0 and got["device_busy_share"] is None
    assert got["placed"] == 4 and all(min(n) >= 4 for n in got["found"].values())
    assert got["extras"] == {} and got["witness"]["objects"] == 4


def test_profile_phase_rehearsal_on_cpu(smoke, grid_root):
    """The profile phase on the grid's own CSVs and on a 24-well plate with
    their columns: each CLI's outputs on the 'card' (here the CPU) equal
    the CPU's."""
    root, _ = grid_root
    got = smoke.run_profile_phase(root, "cpu", n_wells=24, plate_times=("6", "24"))
    for part in ("job", "plate"):
        assert set(got[part]["card_s"]) == {"normalize_cp", "feature_select_cosine", "pycyto_pertime",
                                            "concat_cp", "induction_hit"}
        assert got[part]["csvs"] == 2 + 4 + 3 * 2 + 4
        assert got[part]["kept"] >= 0 and got[part]["ties"] >= 0
    assert got["plate"]["kept"] > 0


def test_tiff_phase_rehearsal_on_cpu(smoke):
    got = smoke.run_tiff_phase("cpu", n=3, size=96, workers=2)
    assert set(got) == {f"{w}_{c}{p}_ms" for w, c, p in
                        [("native", "raw", ""), ("native", "raw", "_pool"), ("pil", "raw", ""),
                         ("native", "lzw", ""), ("native", "lzw", "_pool"), ("pil", "lzw", "")]}


def test_training_rehearsal_on_cpu(smoke, tmp_path):
    """The training phase at 64² (4 pairs, 12 steps of 2) with a 128² field
    and a tiny EfficientNet in the engine: ``train_segmenter`` writes the
    checkpoint, the engine loads it and segments; the numbers come back
    finite. Learning itself is held on the card (``check_training``)."""
    from saguaro_tpu_torch.models.effnetv2 import EffNetV2Config, StageSpec

    tiny = EffNetV2Config(stem_filters=4, stages=(StageSpec("fused", 1, 3, 1, 4, 1),), head_filters=8)
    got = smoke.run_training("cpu", str(tmp_path), n_train=4, n_held=2, size=64, steps=12, batch=2,
                             field=128, field_nuclei=6, effnet=tiny)
    assert got["steps"] == 12 and got["peak_gb"] is None
    assert len(got["held_objects"]) == 2 and got["field_placed"] >= 1
    numbers = [v for k, v in got.items() if isinstance(v, float)]
    assert len(numbers) >= 12 and np.isfinite(numbers).all()
    assert got["s_per_step"] > 0 and got["flows_s"] > 0 and 0 < got["bf16_peak_share"]
    with pytest.raises(AssertionError, match="IoU|halve"):
        smoke.check_training({**got, "first_loss": 1.0, "last_loss": 0.4, "held_iou": 0.4})


def test_training_hold_rehearsal_on_cpu(smoke):
    assert smoke.hold_training_against_cpu("cpu", steps=2, size=32) == 0.0


def test_cpnet_flops_count_every_convolution(smoke):
    """The phase's FLOP count equals torch's own count of the forward's
    convolutions."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from saguaro_tpu_torch.models.cellpose import CellposeConfig, CellposeUNet

    cfg = CellposeConfig(tile=32, features=(4, 8, 16, 32), compute_dtype="float32")
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        CellposeUNet(cfg).eval()(torch.zeros(1, 32, 32, 2))
    convs = sum(n for op, n in counter.get_flop_counts()["Global"].items() if "convolution" in str(op))
    assert smoke.cpnet_conv_flops(cfg, 32) == convs


def test_pointer_jumping_splits_a_cone_nucleus_as_the_reference_does(smoke):
    """The job grid's extra objects (one nucleus split in two by the batched
    path's pointer-jumping recovery, on the card and on the CPU) are the
    reference's own: on a 324² crop of grid site 6/7 (``cone_sites`` seed
    21, site index 6) with ``gradient_cpnet``'s weights, converted for the
    reference by its ``convert_cellpose_state_dict``, both packages'
    ``segment_batch`` give equal labels, with the nucleus at (63, 701) in
    two objects."""
    import jax
    from scipy import ndimage

    from saguaro_tpu.models.cellpose import CellposeConfig as RefCellposeConfig
    from saguaro_tpu.models.cellpose import init_cellpose as ref_init
    from saguaro_tpu.models.cellpose_weights import convert_cellpose_state_dict
    from saguaro_tpu.models.effnetv2 import EffNetV2Config as RefEffConfig
    from saguaro_tpu.models.effnetv2 import StageSpec as RefStage
    from saguaro_tpu.pipeline.segment_embed import SegmentEmbedConfig as RefEngineConfig
    from saguaro_tpu.pipeline.segment_embed import SegmentEmbedEngine as RefEngine
    from saguaro_tpu_torch.models.cellpose import CellposeConfig
    from saguaro_tpu_torch.models.effnetv2 import EffNetV2Config, StageSpec
    from saguaro_tpu_torch.pipeline.segment_embed import SegmentEmbedConfig, SegmentEmbedEngine

    images, centres = smoke.cone_sites(16, 1080, seed=21)
    y0, x0, side = 0, 540, 324
    crop = images[6, y0:y0 + side, x0:x0 + side]
    weights = smoke.gradient_cpnet(CellposeConfig())
    port = SegmentEmbedEngine(
        SegmentEmbedConfig(channels=list(smoke.CHANNELS), effnet=EffNetV2Config(
            stem_filters=4, stages=(StageSpec("fused", 1, 3, 1, 4, 1),), head_filters=8)),
        cellpose_state_dict=weights, device="cpu")
    _, template = ref_init(RefCellposeConfig(), seed=0)
    ref = RefEngine(
        RefEngineConfig(channels=list(smoke.CHANNELS), effnet=RefEffConfig(
            stem_filters=4, stages=(RefStage("fused", 1, 3, 1, 4, 1),), head_filters=8)),
        cellpose_variables=convert_cellpose_state_dict(
            {k: v.numpy() for k, v in weights.items()}, jax.tree.map(np.asarray, template),
            RefCellposeConfig()))
    got = port.segment_batch(crop[None])[0].numpy()
    want = np.asarray(ref.segment_batch(crop[None])[0])
    np.testing.assert_array_equal(got, want)
    com = np.array(ndimage.center_of_mass(got > 0, got, np.arange(1, got.max() + 1)))
    cen = centres[6] - [y0, x0]
    nearest = np.hypot(*(com[:, None, :] - cen[None]).transpose(2, 0, 1)).argmin(1)
    ids, counts = np.unique(nearest, return_counts=True)
    assert [63, 701] in centres[6][ids[counts > 1]].tolist()


def test_bound_picks_the_larger_time(smoke):
    t, by = smoke.bound(3.35e9, 0.0)
    assert by == "bytes" and abs(t - 1.0) < 1e-9
    t, by = smoke.bound(0.0, 67e9)
    assert by == "operations" and abs(t - 1.0) < 1e-9


def test_pixel_path_rehearsal_on_cpu(smoke):
    secs = smoke.run_pixel_path("cpu", size=96, n_fields=2, n_planes=3)
    assert set(secs) == {"max_projection", "rebin", "estimate_illum", "illumination_qc"}
    assert all(v > 0 for v in secs.values())


def test_pixel_small_check_rehearsal_on_cpu(smoke):
    smoke.check_pixel_small_against_cpu("cpu")


def test_resample_hold_rehearsal_on_cpu(smoke):
    import torch

    imgs = np.random.default_rng(0).integers(0, 65535, (2, 60, 80)).astype(np.uint16)
    assert smoke.hold_resample("rehearsal", torch.from_numpy(imgs), (30, 40)) == 0.0
    up = torch.from_numpy(imgs[:1].astype(np.float32))
    # f32 sums against the f64 plain form: rounding only
    assert 0.0 < smoke.hold_resample("rehearsal f32", up, (97, 131)) < 0.1


def test_ptxas_report_reads_each_kernel(smoke):
    text = """ptxas info    : Compiling entry function '_Z18sag_lanes_e_kernelPKi' for 'sm_90a'
ptxas info    : Function properties for _Z18sag_lanes_e_kernelPKi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers, 192 bytes smem, 440 bytes cmem[0]
ptxas info    : Compiling entry function '_Z9sag_countsPKi' for 'sm_90a'
ptxas info    : Function properties for _Z9sag_countsPKi
    16 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 255 registers, 384 bytes cmem[0]
"""
    got = smoke.ptxas_report(text)
    assert got == [
        {"name": "_Z18sag_lanes_e_kernelPKi", "registers": 96, "stack": 0, "spill_stores": 0,
         "spill_loads": 0, "smem": 192},
        {"name": "_Z9sag_countsPKi", "registers": 255, "stack": 16, "spill_stores": 8,
         "spill_loads": 4, "smem": 0},
    ]


def test_range_kernels_attributes_each_launch_once(smoke):
    """``--profile``'s reading of a trace: each device activity counts once,
    in every ``measure/<family>`` range (nested ones too) around the op that
    launched it on that op's thread, PyTorch's and the port's (``sag_*``)
    apart; a port kernel whose op lies in no range, whose op is not in the
    trace, or that is linked to no op (id 0), counts as outside."""
    spans = [(1, 0, 100, "measure/a"), (1, 10, 50, "measure/b"), (1, 200, 300, "measure/c"),
             (2, 0, 1000, "measure/d")]
    ops = [(1, 5, 11), (1, 20, 12), (1, 150, 13), (1, 250, 14), (2, 60, 15), (1, 30, 0)]
    device = [("sag_x", 11, 2.0), ("at::k", 11, 1.0), ("sag_y", 12, 3.0), ("sag_z", 13, 4.0),
              ("at::m", 14, 5.0), ("sag_w", 99, 1.0), ("at::n", 15, 0.5), ("sag_v", 0, 1.0)]
    by_range, port_all, inside = smoke.range_kernels(spans, ops, device)
    assert by_range == {"measure/a": [1.0, 1, 5.0, 2], "measure/b": [0.0, 0, 3.0, 1],
                        "measure/c": [5.0, 1, 0.0, 0], "measure/d": [0.5, 1, 0.0, 0]}
    assert (port_all, inside) == (5, 2)


def test_expected_cells_follow_the_edge_rule(smoke):
    """The embed phase's expected cells: the 14 x 14 inner nuclei of the
    16 x 16 grid at 1080² (196 a site), at the port's own centroids."""
    import torch

    from saguaro_tpu_torch.kernels.crops import in_bounds, label_centroids

    _, gt = smoke.synthetic_sites(2, smoke.SIZE, seed=0)
    got = smoke.expected_cells(gt)
    assert [len(ids) for ids, _ in got] == [196, 196]
    cy, cx, cnt = label_centroids(torch.from_numpy(gt), smoke.MAX_CELLS)
    keep = (cnt > 0) & in_bounds(cy, cx, smoke.SIZE, smoke.SIZE, smoke.BOX)
    for s, (ids, yx) in enumerate(got):
        assert ids.tolist() == keep[s].nonzero().flatten().tolist()
        np.testing.assert_array_equal(yx, torch.stack([cy[s], cx[s]], -1)[keep[s]].numpy())


def test_effnet_cost_and_embed_bound(smoke):
    """EFFNETV2_L at 480² with the folded one-channel stem: 56.05 GMAC a
    crop, and 632.4 MB of bf16 activations (every conv output written and
    read once) plus the f32 input; a one-conv config counted by hand; at
    chip_smoke's 7,840 crops the stage is bound by its bytes."""
    from saguaro_tpu_torch.models.effnetv2 import EFFNETV2_L, EffNetV2Config, StageSpec

    macs, n_bytes = smoke.effnet_cost(EFFNETV2_L, 480)
    assert macs == 56_045_241_408 and n_bytes == 632_390_400
    tiny = EffNetV2Config(stem_filters=4, stages=(StageSpec("fused", 1, 3, 1, 4, 1),), head_filters=8)
    # stem 1->4 at 5² (k3 s2 from 9²), fused 4->4 k3, head 4->8 1x1
    want = 25 * 4 * 9 + 25 * 4 * 4 * 9 + 25 * 8 * 4
    assert smoke.effnet_cost(tiny, 9) == (want, 4 * 25 * (4 + 4 + 8) + 4 * 81)
    t, by, flops, total = smoke.embed_bound(7840, EFFNETV2_L, 480, 200)
    assert by == "bytes" and flops == 2.0 * macs * 7840
    assert abs(t - total / smoke.HBM_BYTES_PER_S) < 1e-12 and 1.4 < t < 1.6


def test_cone_plate_and_gradient_cpnet_find_the_nuclei(smoke, tmp_path):
    """The CLI phase's plate and CPnet: the written TIFFs read back, and
    the engine's batch segmentation at its defaults (flow QC on) finds every
    nucleus of the 8 x 8 grid at 576²."""
    import pandas as pd

    from saguaro_tpu_torch.io import tiff
    from saguaro_tpu_torch.models.cellpose import CellposeConfig
    from saguaro_tpu_torch.models.effnetv2 import EffNetV2Config, StageSpec
    from saguaro_tpu_torch.pipeline.segment_embed import SegmentEmbedConfig, SegmentEmbedEngine

    images, centres = smoke.cone_sites(1, 576, seed=3)
    assert images.dtype == np.uint16 and images.shape == (1, 576, 576, 5) and centres.shape == (1, 64, 2)
    load_data = pd.read_csv(smoke.write_plate(str(tmp_path), images))
    name = load_data.loc[0, "FileName_ER"]
    np.testing.assert_array_equal(tiff.imread(str(tmp_path / "Images" / name)), images[0, ..., 2])
    tiny = EffNetV2Config(stem_filters=4, stages=(StageSpec("fused", 1, 3, 1, 4, 1),), head_filters=1280)
    engine = SegmentEmbedEngine(SegmentEmbedConfig(channels=list(smoke.CHANNELS), effnet=tiny),
                                cellpose_state_dict=smoke.gradient_cpnet(CellposeConfig()), device="cpu")
    labels = engine.segment_batch(images)[0].numpy()
    at_centres = labels[centres[0, :, 0], centres[0, :, 1]]
    assert (at_centres > 0).all() and len(set(at_centres.tolist())) == 64
    ids, _ = smoke.expected_cells(labels[None])[0]
    assert set(ids.tolist()) >= set(at_centres[(centres[0] >= 100).all(1) & (centres[0] <= 476).all(1)].tolist())


@pytest.fixture(scope="module")
def main_cpu(smoke):
    """The main path at 2 sites of 200² on the CPU, for the phases after it."""
    images, gt = smoke.synthetic_sites(2, 200, seed=3)
    tables, rec, _ = smoke.run_main_path(images, gt, "cpu")
    return images, gt, rec, tables


def test_fine_costes_rehearsal_on_cpu(smoke, main_cpu, monkeypatch):
    """The fine Costes phase: K3's plain form runs at ``costes_fine_refine``
    (the phase's K3Sites wraps it here), every walk stopped on CP's rule
    inside its window; the card-vs-CPU check on the 128² corners."""
    monkeypatch.setattr(smoke, "K3_WRAPPED", "sums_plain")
    images, _, rec, _ = main_cpu
    fine, k3 = smoke.run_fine_costes(images, rec, "cpu", 4)
    assert fine["k3_launches"] == k3.calls[smoke.K3_FINE_SITE] > 0
    assert fine["thresholds"] == 2 * 10 and 0 <= fine["in_bracket"] <= 20
    assert fine["truncated"] == 0
    assert fine["costes_columns"] == 2 * 3 * 20
    assert smoke.check_fine_costes_against_cpu(images, rec, "cpu")["max_steps"] == 0.0
    assert smoke.fine_window(2.0, 65535, 255) == (2 * 257 - 2828, 514)


def test_oracles_rehearsal_on_cpu(smoke, main_cpu, monkeypatch):
    monkeypatch.setattr(smoke, "K3_WRAPPED", "sums_plain")
    images, gt, _, _ = main_cpu
    got = smoke.check_oracles(images, gt, "cpu")
    assert set(got["k3_calls"]) == {"moments_features", "multichannel_stats",
                                    "edge_intensity_multichannel", "radial_distribution_multichannel"}
    assert set(got["worst_of_tol"]) == {"moments", "intensity", "edge", "radial", "corr"}


def test_granularity_rehearsal_on_cpu(smoke, main_cpu):
    got = smoke.check_granularity(main_cpu[0], "cpu")
    assert got["max_abs_err"] == 0.0 and got["scale"] > 0


def test_mesh_rehearsal_on_cpu(smoke, main_cpu):
    """The mesh phase on a 2-entry CPU mesh with a tiny EfficientNet: cone
    sites segmented sharded as unsharded (3 and 2 sites, the second padded),
    the measurement sharded against the main path's tables, the pooled
    embed and 3 training steps with and without the mesh."""
    from saguaro_tpu_torch.models.effnetv2 import EffNetV2Config, StageSpec
    from saguaro_tpu_torch.pipeline.segment_embed import SegmentEmbedConfig

    images, gt, rec, tables = main_cpu
    tiny = EffNetV2Config(stem_filters=4, stages=(StageSpec("fused", 1, 3, 1, 4, 1),),
                          head_filters=1280, input_size=32)
    cfg = SegmentEmbedConfig(channels=list(smoke.CHANNELS), diameter=100.0, box_size=40,
                             embed_size=32, embed_chunk=8, effnet=tiny)
    got = smoke.run_mesh_phase(images, gt, rec, tables, "cpu", [], cfg=cfg)
    assert got["segment_2_objects"] == [4, 4] and got["segment_1_objects"] == [4]
    assert got["measure_2_worst"] <= 1e-4 and got["train_loss_rel"] <= smoke.MESH_LOSS_RTOL
    assert len(got["shard_launches"]) == 2  # one dispatch a shard, counted on its own


def test_shard_launch_check_names_the_idle_shard(smoke):
    """Every shard of a sharded measurement must launch each kernel, and the
    shards' counts must add up to the run's."""
    a, b = {"seg_counts": 49, "seg_pick2": 1}, {"seg_counts": 49, "seg_pick2": 0}
    smoke.check_shard_launches([a, dict(a)], {"seg_counts": 98, "seg_pick2": 2}, 2, ["seg_pick2"])
    with pytest.raises(AssertionError, match="shard 1 .* did not launch \\['seg_pick2'\\]"):
        smoke.check_shard_launches([a, b], {"seg_counts": 98, "seg_pick2": 1}, 2, ["seg_pick2"])
    with pytest.raises(AssertionError, match="do not add up"):
        smoke.check_shard_launches([a, dict(a)], {"seg_counts": 147, "seg_pick2": 2}, 2, [])
    with pytest.raises(AssertionError, match="1 shards, not 2"):
        smoke.check_shard_launches([a], {"seg_counts": 49, "seg_pick2": 1}, 2, [])
