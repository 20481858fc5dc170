"""Package boundaries of the PyTorch port: it imports neither JAX nor the
reference package, its entry points refuse to fall back to the CPU, its
CUDA wrappers refuse CPU tensors, every family of the default config is
measured, and the one unported option is refused."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from saguaro_tpu_torch import resolve_device
from saguaro_tpu_torch.kernels import resample
from saguaro_tpu_torch.kernels import segment_cuda as sc
from saguaro_tpu_torch.pipeline.features import FeatureConfig, measure_site_batch

from .torch_data import share_cpu_threads

share_cpu_threads()

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "saguaro_tpu", "bench", "__graft_entry__")


def _port_sources():
    files = sorted((ROOT / "saguaro_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    return files


def test_import_leaves_out_jax_and_reference():
    code = (
        "import sys, saguaro_tpu_torch\n"
        "import saguaro_tpu_torch.pipeline.feature_extraction\n"
        "import saguaro_tpu_torch.pipeline.segment_embed\n"
        "import saguaro_tpu_torch.pipeline.pixel_stages\n"
        "import saguaro_tpu_torch.cli.estimate_illum\n"
        "import saguaro_tpu_torch.cli.segment_embed\n"
        "import saguaro_tpu_torch.kernels.crops\n"
        "import saguaro_tpu_torch.models.effnetv2\n"
        "import saguaro_tpu_torch.models.weights\n"
        "import saguaro_tpu_torch.models.xgb\n"
        "import saguaro_tpu_torch.pipeline.manifest\n"
        "import saguaro_tpu_torch.utils.timing\n"
        "import saguaro_tpu_torch.config, saguaro_tpu_torch.io.fast_tiff\n"
        "import saguaro_tpu_torch.ops, saguaro_tpu_torch.ops.aggregate\n"
        "import saguaro_tpu_torch.pipeline.profile_stages, saguaro_tpu_torch.pipeline.hits\n"
        "import saguaro_tpu_torch.parallel.distributed, saguaro_tpu_torch.plots.venn\n"
        "import saguaro_tpu_torch.cli.feature_extraction, saguaro_tpu_torch.cli.normalize_cp\n"
        "import saguaro_tpu_torch.cli.pycyto_pertime, saguaro_tpu_torch.cli.concat_cp\n"
        "import saguaro_tpu_torch.cli.feature_select_cosine, saguaro_tpu_torch.cli.induction_hit\n"
        "import saguaro_tpu_torch.cli.train_segmenter, saguaro_tpu_torch.models.cellpose_train\n"
        "import saguaro_tpu_torch.models.checkpoint, saguaro_tpu_torch.models.cellpose_weights\n"
        "import saguaro_tpu_torch.models.effnet_weights\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'msgpack', 'saguaro_tpu', "
        "'matplotlib', 'seaborn')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True
    )
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_module_imports_nothing_of_jax_or_reference(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_refuses_cpu_fallback(monkeypatch):
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")


def _slice_cfg():
    return FeatureConfig(
        channels=("DNA", "GFP"), max_cells=8, measure_texture=False,
        measure_quantiles=False, measure_radius=False, measure_convex=False,
        measure_neighbors=False, measure_colocalization=False, measure_radial=False,
    )


def _entry_measure():
    measure_site_batch(np.zeros((1, 16, 16, 2), np.float32), np.zeros((1, 16, 16), np.int32), _slice_cfg())


def _entry_engine():
    from saguaro_tpu_torch.pipeline.segment_embed import SegmentEmbedConfig, SegmentEmbedEngine

    SegmentEmbedEngine(SegmentEmbedConfig(channels=["DNA"]))


def _entry_masks():
    from saguaro_tpu_torch.kernels.flow_ode import compute_masks_batch

    compute_masks_batch(np.zeros((1, 2, 8, 8), np.float32), np.zeros((1, 8, 8), np.float32))


def _entry_job():
    import pandas as pd

    from saguaro_tpu_torch.pipeline.feature_extraction import run_feature_extraction_job

    run_feature_extraction_job(pd.DataFrame(), "x", "y", ["DNA"], lambda im: im)


def _entry_cellpose():
    from saguaro_tpu_torch.models.cellpose import init_cellpose

    init_cellpose()


def _entry_max_projection():
    from saguaro_tpu_torch.pipeline.pixel_stages import run_max_projection

    run_max_projection("x", "index.csv", 1, 1, "y")


def _entry_rebin():
    from saguaro_tpu_torch.pipeline.pixel_stages import run_rebin

    run_rebin("x", "Images/")


def _entry_illumination_qc():
    from saguaro_tpu_torch.pipeline.pixel_stages import run_illumination_qc

    run_illumination_qc("x.csv", "y", ["DNA"], "out.csv")


def _entry_estimate_illumination():
    from saguaro_tpu_torch.kernels.illum import estimate_illumination

    estimate_illumination(np.zeros((1, 8, 8), np.float32), sigma=1)


def _entry_effnet():
    from saguaro_tpu_torch.models.effnetv2 import init_effnetv2

    init_effnetv2()


def _entry_xgb():
    from saguaro_tpu_torch.models.xgb import XGBEnsemble

    XGBEnsemble.from_json('{"learner": {}}')


def _entry_grid():
    from saguaro_tpu_torch.pipeline.feature_extraction import run_batch_processing

    run_batch_processing("x", "y", ["P1"], ["6"], ["DNA"], str, str, lambda im: im)


def _entry_dispatch():
    from saguaro_tpu_torch.pipeline.features import measure_site_batch_dispatch

    measure_site_batch_dispatch(np.zeros((1, 16, 16, 2), np.float32), np.zeros((1, 16, 16), np.int32),
                                _slice_cfg())


def _entry_normalize():
    import pandas as pd

    from saguaro_tpu_torch.ops import normalize_profiles

    normalize_profiles(pd.DataFrame({"f": [1.0, 2.0]}))


def _entry_select():
    import pandas as pd

    from saguaro_tpu_torch.ops import feature_select

    feature_select(pd.DataFrame({"f": [1.0, 2.0], "g": [2.0, 1.0]}))


def _entry_cosine():
    import pandas as pd

    from saguaro_tpu_torch.ops import group_cosine_similarity

    group_cosine_similarity(pd.DataFrame({"Metadata_Compound": ["a"], "Metadata_Timepoint": ["6"],
                                          "Metadata_ConcLevel": [1], "f": [1.0]}))


def _entry_hits():
    from saguaro_tpu_torch.pipeline.hits import run_induction_hit

    run_induction_hit("x", "features.csv", "out")


def _entry_masks_to_flows():
    from saguaro_tpu_torch.models.cellpose_train import masks_to_flows

    masks_to_flows(np.ones((8, 8), np.int32))


def _entry_train_cellpose():
    from saguaro_tpu_torch.models.cellpose import CellposeConfig
    from saguaro_tpu_torch.models.cellpose_train import train_cellpose

    train_cellpose(np.zeros((1, 8, 8, 2), np.float32), np.zeros((1, 2, 8, 8), np.float32),
                   np.zeros((1, 8, 8), np.float32), CellposeConfig(tile=8, features=(2, 2, 2, 2)), n_steps=1)


def _entry_train_segmenter():
    from saguaro_tpu_torch.cli.train_segmenter import main

    main(["--data_dir", "x", "--output", "y.ckpt"])


@pytest.mark.parametrize(
    "entry", [_entry_measure, _entry_engine, _entry_masks, _entry_job, _entry_cellpose,
              _entry_max_projection, _entry_rebin, _entry_illumination_qc,
              _entry_estimate_illumination, _entry_effnet, _entry_xgb, _entry_grid,
              _entry_dispatch, _entry_normalize, _entry_select, _entry_cosine, _entry_hits,
              _entry_masks_to_flows, _entry_train_cellpose, _entry_train_segmenter]
)
def test_entry_point_without_device_raises_when_cuda_absent(monkeypatch, entry):
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        entry()


def _cpu_wrapper_calls():
    from saguaro_tpu_torch.kernels.resample_cuda import lanczos_resize_cuda

    bands = tuple(torch.as_tensor(a) for a in resample.axis_bands(8, 4))
    lab = torch.zeros((1, 8), dtype=torch.int32)
    img = torch.zeros((1, 4, 2, 1))
    lab3 = torch.zeros((1, 4, 2), dtype=torch.int32)
    bnd = torch.zeros((1, 4, 2), dtype=torch.uint8)
    img3 = torch.zeros((1, 8, 2))
    return {
        "seg_counts": lambda: sc.seg_counts(lab, torch.zeros((1, 1, 8), dtype=torch.int16), (1,), 4),
        "seg_take_t": lambda: sc.seg_take_t(torch.zeros((1, 4, 2)), lab, 4),
        "seg_sums": lambda: sc.seg_sums(lab, torch.zeros((1, 8, 1)), 4),
        "seg_lane_sums_a": lambda: sc.seg_lane_sums_a(lab3, img, torch.zeros((1, 4, 2)), bnd, 4, True),
        "seg_lane_sums_c": lambda: sc.seg_lane_sums_c(
            lab3, img, bnd, torch.zeros((1, 4, 5)), torch.zeros((30, 10)), 4, True, True, True
        ),
        "seg_lane_sums_e": lambda: sc.seg_lane_sums_e(
            lab, img3, img3, torch.zeros((1, 4, 2)), torch.zeros((1, 3, 1)), 4
        ),
        "seg_radial_sums": lambda: sc.seg_radial_sums(lab, lab, img3, 4, 8),
        "seg_edt_sweep": lambda: sc.seg_edt_sweep(torch.zeros((1, 4, 2)), torch.zeros((1, 4, 2)), 2),
        "seg_pick2": lambda: sc.seg_pick2(
            torch.zeros((1, 8, 1), dtype=torch.int32), torch.zeros((1, 8, 1), dtype=torch.int32),
            torch.zeros((1, 1, 256, 256, 1)),
        ),
        "lanczos_resize": lambda: lanczos_resize_cuda(
            torch.zeros((1, 8, 6), dtype=torch.uint16), bands, bands, None, (4, 4)
        ),
    }


@pytest.mark.parametrize("name", list(sc.LAUNCHES))
def test_cuda_wrapper_refuses_cpu_tensors(name):
    before = dict(sc.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensor"):
        _cpu_wrapper_calls()[name]()
    assert sc.LAUNCHES == before


@pytest.mark.parametrize("flag,family", [("costes_fine_scale", "costes")])
def test_unported_family_raises_naming_it(flag, family):
    import dataclasses

    cfg = dataclasses.replace(_slice_cfg(), **{flag: 65535})
    with pytest.raises(NotImplementedError, match=family):
        measure_site_batch(
            np.zeros((1, 16, 16, 2), np.float32), np.zeros((1, 16, 16), np.int32), cfg,
            device="cpu",
        )


@pytest.mark.parametrize(
    "flag,value,column",
    [
        ("measure_texture", True, "Texture_Contrast_GFP_3_00_16"),
        ("measure_quantiles", True, "Intensity_MedianIntensity_GFP"),
        ("measure_radius", True, "AreaShape_MedianRadius"),
        ("measure_convex", True, "AreaShape_Solidity"),
        ("measure_neighbors", True, "Neighbors_NumberOfNeighbors_5"),
        ("measure_radial", True, "RadialDistribution_RadialCV_GFP_1of4"),
        ("measure_colocalization", True, "Correlation_Costes_DNA_GFP"),
        ("secondary_threshold_scope", "adaptive", "AreaShape_Area"),
        ("secondary_threshold_smoothing", 1.0, "AreaShape_Area"),
    ],
)
def test_each_default_family_is_measured(flag, value, column):
    """Each family (or threshold option) alone on ``_slice_cfg`` (every
    optional family off) adds its columns to the object tables; the values
    are held against the reference in test_torch_features and the
    per-module tests."""
    import dataclasses

    from .torch_data import blob_sites

    img, lab = blob_sites(n_sites=1, h=40, w=44, n_ch=2, n_cells=5, seed=2)
    cfg = dataclasses.replace(_slice_cfg(), secondary_adaptive_window=12, **{flag: value})
    base = measure_site_batch(img, lab, _slice_cfg(), device="cpu")[0]
    got = measure_site_batch(img, lab, cfg, device="cpu")[0]
    assert column in got["Cells"].columns
    assert len(got["Cells"]) == len(base["Cells"]) > 0
    assert np.isfinite(got["Cells"].select_dtypes("number").to_numpy(np.float64)).all()


def test_pallas_dispatch_pin_refused():
    with pytest.raises(ValueError, match="tensor device"):
        FeatureConfig(channels=("DNA",), pallas_dispatch=True)


def test_feature_extraction_cli_refuses_several_devices():
    from saguaro_tpu_torch.cli.feature_extraction import main

    with pytest.raises(NotImplementedError, match="devices=2"):
        main(["--bucket_name", "x", "--base_output_path", "y", "--plates", "P1", "--channels", "DNA",
              "--image_path_template", "{plate}", "--load_data_template", "{plate}.csv",
              "--devices", "2", "--device", "cpu"])


def _calls_share_cpu_threads(tree: ast.Module) -> bool:
    """A module-level ``share_cpu_threads()`` after its import from
    ``.torch_data``."""
    imported = any(isinstance(n, ast.ImportFrom) and n.module == "torch_data" and n.level == 1
                   and any(a.name == "share_cpu_threads" for a in n.names) for n in tree.body)
    called = any(isinstance(n, ast.Expr) and isinstance(n.value, ast.Call)
                 and getattr(n.value.func, "id", None) == "share_cpu_threads" for n in tree.body)
    return imported and called


@pytest.mark.parametrize("path", sorted((ROOT / "tests").glob("test_torch_*.py")),
                         ids=lambda p: p.name)
def test_every_torch_test_file_shares_the_cpu_threads(path):
    """Under pytest-xdist each worker runs torch on its share of the cores
    (``torch_data.share_cpu_threads``), called by every port test file when
    it is imported."""
    assert _calls_share_cpu_threads(ast.parse(path.read_text())), path.name


def test_share_cpu_threads_divides_the_cores(monkeypatch):
    from .torch_data import share_cpu_threads

    before = torch.get_num_threads()
    try:
        monkeypatch.setattr(os, "cpu_count", lambda: 8)
        monkeypatch.setenv("PYTEST_XDIST_WORKER_COUNT", "6")
        share_cpu_threads()
        assert torch.get_num_threads() == 1
        monkeypatch.setenv("PYTEST_XDIST_WORKER_COUNT", "2")
        share_cpu_threads()
        assert torch.get_num_threads() == 4
        monkeypatch.delenv("PYTEST_XDIST_WORKER_COUNT")
        torch.set_num_threads(3)
        share_cpu_threads()
        assert torch.get_num_threads() == 3
    finally:
        torch.set_num_threads(before)
