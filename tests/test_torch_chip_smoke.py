"""chip_smoke.py without a card: it exits non-zero and prints no result,
in the repository and in a directory holding nothing else; its main path
(engine -> mask recovery -> measurement -> job) rehearses on the CPU at a
small size through the plain forms."""

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
