"""Package boundaries of the PyTorch port: it imports neither JAX nor the
reference package, its entry points refuse to fall back to the CPU, its
CUDA wrappers refuse CPU tensors, every family of the default config is
measured, and so are the second-level Costes descent and the CLI's
device mesh; and every public name of a reference module has a counterpart
of that name in the port's mirrored module (or an exemption with its
reason), and the four package surfaces export the reference's names."""

import ast
import os
import re
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
        "import saguaro_tpu_torch.parallel.mesh, saguaro_tpu_torch.kernels.moments\n"
        "import saguaro_tpu_torch.kernels.multichannel\n"
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
        "sag_granularity": lambda: sc.sag_granularity(torch.zeros((1, 4, 2)), 3),
    }


@pytest.mark.parametrize("name", list(sc.LAUNCHES))
def test_cuda_wrapper_refuses_cpu_tensors(name):
    before = dict(sc.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensor"):
        _cpu_wrapper_calls()[name]()
    assert sc.LAUNCHES == before


def test_costes_fine_scale_is_measured():
    """``costes_fine_scale`` (the second-level Costes descent) measures the
    Costes columns: finite, the same rows and columns as the coarse
    descent's; the values are held against the reference in
    test_torch_costes_fine."""
    import dataclasses

    from .torch_data import blob_sites

    img, lab = blob_sites(n_sites=2, h=40, w=44, n_ch=2, n_cells=5, seed=2)
    coarse = dataclasses.replace(_slice_cfg(), measure_colocalization=True)
    fine = dataclasses.replace(coarse, costes_fine_scale=65535)
    base = measure_site_batch(img.astype(np.uint16), lab, coarse, device="cpu")
    got = measure_site_batch(img.astype(np.uint16), lab, fine, device="cpu")
    for b, g in zip(base, got):
        for name in ("Nuclei", "Cells", "Cytoplasm"):
            assert list(g[name].columns) == list(b[name].columns) and len(g[name]) == len(b[name])
            costes = g[name][["Correlation_Costes_DNA_GFP", "Correlation_Costes_GFP_DNA"]]
            assert len(costes) > 0 and np.isfinite(costes.to_numpy(np.float64)).all()


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


@pytest.mark.parametrize("devices,device,size", [
    ("2", None, 2), ("4", None, 4), ("1", None, None), (None, None, None), (None, "cpu", None),
    ("1", "cpu", None)])
def test_feature_extraction_cli_builds_a_mesh(monkeypatch, devices, device, size):
    """``--devices`` sizes the mesh (``default_mesh_for``) that both the
    engine and the job grid shard over, among the visible devices (8
    entries here, patched); unset or 1, no mesh, and none with ``--device
    cpu`` either."""
    from saguaro_tpu_torch.cli.feature_extraction import main
    from saguaro_tpu_torch.parallel import mesh as pm
    from saguaro_tpu_torch.pipeline import feature_extraction as fe
    from saguaro_tpu_torch.pipeline import segment_embed as se

    monkeypatch.setattr(pm, "visible_devices", lambda: [torch.device("cpu")] * 8)
    seen = {}

    class Engine:
        def __init__(self, cfg, device=None, mesh=None):
            seen["engine"] = mesh

    def grid(**kw):
        seen["grid"] = kw["mesh"]
        return {}

    monkeypatch.setattr(se, "SegmentEmbedEngine", Engine)
    monkeypatch.setattr(fe, "run_batch_processing", grid)
    argv = ["--bucket_name", "x", "--base_output_path", "y", "--plates", "P1", "--channels", "DNA",
            "--image_path_template", "{plate}", "--load_data_template", "{plate}.csv",
            ] + (["--devices", devices] if devices else []) + (["--device", device] if device else [])
    main(argv)
    assert seen["engine"] is seen["grid"]
    assert (seen["grid"] is None) if size is None else seen["grid"].size == size


def test_feature_extraction_cli_refuses_a_mesh_on_the_cpu(monkeypatch):
    """``--device cpu --devices 2`` asks for two things at once: refused,
    with the visible devices patched to eight."""
    from saguaro_tpu_torch.cli.feature_extraction import main
    from saguaro_tpu_torch.parallel import mesh as pm

    monkeypatch.setattr(pm, "visible_devices", lambda: [torch.device("cpu")] * 8)
    argv = ["--bucket_name", "x", "--base_output_path", "y", "--plates", "P1", "--channels", "DNA",
            "--image_path_template", "{plate}", "--load_data_template", "{plate}.csv",
            "--device", "cpu", "--devices", "2"]
    with pytest.raises(ValueError, match="mesh of 2 devices asked for with device cpu"):
        main(argv)


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


# --------------------------------------------------------------------------
# The public surface: every public name of a reference module has a
# counterpart of that name in the port's mirrored module

REF = ROOT / "saguaro_tpu"
PORT = ROOT / "saguaro_tpu_torch"
# the two Pallas files map to the port's CUDA wrappers
MIRROR = {"kernels/segment_pallas.py": "kernels/segment_cuda.py",
          "kernels/resample_pallas.py": "kernels/resample_cuda.py"}
_PALLAS_FN = "the Pallas kernel; its hand-written CUDA counterpart is the port's {}"
_DISPATCH = "the TPU's Pallas dispatch switch; in the port the tensor's device picks the kernel"
# (reference module, name): why the port has no counterpart of that name
EXEMPT = {
    ("kernels/segment_pallas.py", "use_pallas"): _DISPATCH,
    ("kernels/segment_pallas.py", "dispatch_override"): _DISPATCH,
    ("kernels/segment_pallas.py", "seg_counts_pallas"): _PALLAS_FN.format("seg_counts"),
    ("kernels/segment_pallas.py", "seg_take_t_pallas"): _PALLAS_FN.format("seg_take_t"),
    ("kernels/segment_pallas.py", "seg_sums_pallas"): _PALLAS_FN.format("seg_sums"),
    ("kernels/segment_pallas.py", "seg_lane_sums_pallas"): _PALLAS_FN.format("seg_lane_sums_a"),
    ("kernels/segment_pallas.py", "pick2_pallas"): _PALLAS_FN.format("seg_pick2"),
    ("kernels/resample_pallas.py", "lanczos_resize_pallas"): _PALLAS_FN.format("lanczos_resize_cuda"),
    ("kernels/resample_pallas.py", "lanczos_resize_batch_pallas"):
        _PALLAS_FN.format("lanczos_resize_cuda"),
    ("io/fast_tiff.py", "available"): "the probe for the reference's silent fallback to imageio, "
                                      "which the port refuses: a failed native build raises",
}
_COUNTERPART = re.compile(r"the port's (\w+)$")


def _public_names(tree: ast.Module) -> list[str]:
    """The module's ``__all__``, else its top-level functions and classes
    without a leading underscore."""
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
            return [ast.literal_eval(e) for e in node.value.elts]
    return [n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
            and not n.name.startswith("_")]


def _defined_names(tree: ast.Module) -> set[str]:
    """Every name bound at the module's top level."""
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update(a.asname or a.name.split(".")[0] for a in node.names)
    return names


def _ref_modules() -> list[str]:
    return [str(p.relative_to(REF)) for p in sorted(REF.rglob("*.py"))]


@pytest.mark.parametrize("rel", _ref_modules())
def test_every_public_name_has_a_port_counterpart(rel):
    """Parsed with ``ast``, so no JAX program is built: each public name of
    the reference module is bound in the port's mirrored module, or stands
    in EXEMPT with its reason."""
    ref = _public_names(ast.parse((REF / rel).read_text()))
    port = PORT / MIRROR.get(rel, rel)
    assert port.exists(), f"the port has no module for {rel}"
    defined = _defined_names(ast.parse(port.read_text()))
    missing = [n for n in ref if n not in defined and (rel, n) not in EXEMPT]
    assert not missing, f"{rel}: no counterpart in {port.relative_to(ROOT)} for {missing}"


def test_exemptions_name_only_missing_public_names():
    """Each exemption is a public name of its reference module that the port
    does not bind, and a Pallas function's named CUDA counterpart exists."""
    for (rel, name), why in EXEMPT.items():
        assert name in _public_names(ast.parse((REF / rel).read_text())), (rel, name)
        port = PORT / MIRROR.get(rel, rel)
        defined = _defined_names(ast.parse(port.read_text()))
        assert name not in defined, (rel, name)
        m = _COUNTERPART.search(why)
        if m:
            assert m.group(1) in defined, (rel, name, m.group(1))


@pytest.mark.parametrize("package", ["kernels", "models", "io", "utils"])
def test_package_exports_the_reference_names(package):
    """Every name the reference's package ``__init__`` exports imports from
    the port's package, and the two ``__all__`` hold the same names."""
    import importlib

    ref = _public_names(ast.parse((REF / package / "__init__.py").read_text()))
    assert ref
    mod = importlib.import_module(f"saguaro_tpu_torch.{package}")
    for name in ref:
        assert getattr(mod, name, None) is not None, f"saguaro_tpu_torch.{package}.{name}"
    assert sorted(mod.__all__) == sorted(ref)


def test_package_surfaces_import_no_jax_and_build_nothing():
    """Importing the four packages imports no JAX and builds no CUDA source
    (the kernels build at their first launch)."""
    code = (
        "import sys\n"
        "import saguaro_tpu_torch.kernels, saguaro_tpu_torch.models\n"
        "import saguaro_tpu_torch.io, saguaro_tpu_torch.utils\n"
        "from saguaro_tpu_torch.kernels import segment_cuda as sc\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'saguaro_tpu')]\n"
        "sys.exit(1 if bad or sc._LIB is not None else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True)
    assert res.returncode == 0, res.stdout + res.stderr
