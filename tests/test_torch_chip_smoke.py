"""chip_smoke.py without a card: it exits non-zero and prints no result,
in the repository and in a directory holding nothing else; its main path
(engine -> mask recovery -> measurement -> job), its single-site phase
(engine segment, Euler recovery held against the ground truth and the
CPU) and its pixel path
(max projection -> re-binning -> illumination estimate -> QC) rehearse on
the CPU at a small size through the plain forms; and ``--profile``'s
reading of a trace by ``measure/<family>`` range holds on synthetic
events."""

import importlib.util
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

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


def test_job_rehearsal_on_cpu(smoke):
    images, gt = smoke.synthetic_sites(2, 200, seed=4)
    smoke.run_job(images, gt, "cpu")


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
