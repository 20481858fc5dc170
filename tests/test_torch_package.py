"""Package boundaries of the PyTorch port: it imports neither JAX nor the
reference package, its entry points refuse to fall back to the CPU, its
CUDA wrappers refuse CPU tensors, and unported families are refused."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from saguaro_tpu_torch import resolve_device
from saguaro_tpu_torch.kernels import segment_cuda as sc
from saguaro_tpu_torch.pipeline.features import FeatureConfig, measure_site_batch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "saguaro_tpu", "bench", "__graft_entry__")


def _port_sources():
    files = sorted((ROOT / "saguaro_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    return files


def test_import_leaves_out_jax_and_reference():
    code = (
        "import sys, saguaro_tpu_torch\n"
        "import saguaro_tpu_torch.pipeline.feature_extraction\n"
        "import saguaro_tpu_torch.pipeline.segment_embed\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'saguaro_tpu')]\n"
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


@pytest.mark.parametrize("entry", [_entry_measure, _entry_engine, _entry_masks, _entry_job])
def test_entry_point_without_device_raises_when_cuda_absent(monkeypatch, entry):
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        entry()


def _cpu_wrapper_calls():
    lab = torch.zeros((1, 8), dtype=torch.int32)
    img = torch.zeros((1, 4, 2, 1))
    lab3 = torch.zeros((1, 4, 2), dtype=torch.int32)
    bnd = torch.zeros((1, 4, 2), dtype=torch.uint8)
    return {
        "seg_counts": lambda: sc.seg_counts(lab, torch.zeros((1, 1, 8), dtype=torch.int32), (1,), 4),
        "seg_take_t": lambda: sc.seg_take_t(torch.zeros((1, 4, 2)), lab, 4),
        "seg_sums": lambda: sc.seg_sums(lab, torch.zeros((1, 8, 1)), 4),
        "seg_lane_sums_a": lambda: sc.seg_lane_sums_a(lab3, img, torch.zeros((1, 4, 2)), bnd, 4, True),
        "seg_lane_sums_c": lambda: sc.seg_lane_sums_c(
            lab3, img, bnd, torch.zeros((1, 4, 5)), torch.zeros((30, 10)), 4, True, True, True
        ),
    }


@pytest.mark.parametrize("name", list(sc.LAUNCHES))
def test_cuda_wrapper_refuses_cpu_tensors(name):
    before = dict(sc.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensor"):
        _cpu_wrapper_calls()[name]()
    assert sc.LAUNCHES == before


@pytest.mark.parametrize(
    "flag,family",
    [
        ("measure_texture", "texture"),
        ("measure_quantiles", "quantiles"),
        ("measure_radius", "radii"),
        ("measure_convex", "convex"),
        ("measure_neighbors", "neighbors"),
        ("measure_radial", "radial"),
        ("measure_colocalization", "colocalization"),
        ("secondary_threshold_scope", "adaptive"),
        ("secondary_threshold_smoothing", "smoothing"),
    ],
)
def test_unported_family_raises_naming_it(flag, family):
    import dataclasses

    value = {"secondary_threshold_scope": "adaptive", "secondary_threshold_smoothing": 1.0}.get(flag, True)
    cfg = dataclasses.replace(_slice_cfg(), **{flag: value})
    with pytest.raises(NotImplementedError, match=family):
        measure_site_batch(
            np.zeros((1, 16, 16, 2), np.float32), np.zeros((1, 16, 16), np.int32), cfg,
            device="cpu",
        )


def test_pallas_dispatch_pin_refused():
    with pytest.raises(ValueError, match="tensor device"):
        FeatureConfig(channels=("DNA",), pallas_dispatch=True)
