"""On the card (marker ``cuda``): one short run of each cell through the
command's own entry, its last line held to the contract.

    python -m pytest -m cuda hcs_bench/tests/test_hcs_bench_card.py
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_short_run_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run([sys.executable, "hcs_bench/run.py", "--workload", cell, "--seed", "4000000001",
                          "--seconds", "5", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert line["correct"] and line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert "saguaro_tpu_torch" not in out.stdout
