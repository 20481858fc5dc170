"""The port's job grid across two real processes (the counterpart of
``tests/test_multihost.py``): two Python processes, CPU only, importing
torch and never JAX, join one gloo process group over a localhost
coordinator (``parallel.distributed.maybe_initialize``), and each runs
``run_batch_processing`` over a 3-plate x 2-timepoint grid of tiny jobs
(64² images, 2 wells, the ground-truth segmenter) into one shared output
root. Their jobs are disjoint and cover the grid, the shared manifest marks
all six, and a second two-process pass executes nothing and rewrites no
file. Each process gets 120 s, so that a hung rendezvous fails the test."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from .fixtures import make_fake_plate
from .torch_data import share_cpu_threads

share_cpu_threads()

REPO = Path(__file__).resolve().parents[1]
PLATES, TIMES = ["P1", "P2", "P3"], ["6", "24"]
JOBS = [f"{p}/{t}" for p in PLATES for t in TIMES]

WORKER = r"""
import json, os, sys

import numpy as np
import torch

from saguaro_tpu_torch.parallel.distributed import maybe_initialize, process_info
from saguaro_tpu_torch.pipeline.feature_extraction import run_batch_processing
from saguaro_tpu_torch.pipeline.features import FeatureConfig

coord, pid, root = sys.argv[1], int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)
maybe_initialize(coord, 2, pid)
assert process_info() == (pid, 2), process_info()
# both processes are in one group: a collective sees them both
total = torch.tensor([pid + 1.0])
torch.distributed.all_reduce(total)
assert total.item() == 3.0, total


class Masks:
    # replays a job's ground-truth masks in LoadData row order
    queue = []

    def __call__(self, image):
        return self.queue.pop(0)


seg = Masks()


def load_data_key(plate, t):
    seg.queue = [np.load(os.path.join(root, plate, t, f"mask_{i}.npy")) for i in range(2)]
    return f"{plate}/{t}/load_data.csv"


cfg = FeatureConfig(channels=("DNA", "GFP"), max_cells=8, granularity_length=3,
                    measure_texture=False, measure_quantiles=False, measure_radius=False,
                    measure_convex=False, measure_neighbors=False,
                    measure_colocalization=False, measure_radial=False)
done = run_batch_processing(
    bucket_name=root, base_output_path=os.path.join(root, "out"), plates=["P1", "P2", "P3"],
    times=["6", "24"], channels=["DNA", "GFP"],
    image_path_for_job=lambda p, t: f"{p}/{t}/Images", load_data_key_for_job=load_data_key,
    segmenter=seg, feature_cfg=cfg, site_batch=2, device="cpu")
torch.distributed.barrier()
torch.distributed.destroy_process_group()
print(json.dumps({"pid": pid, "jax": "jax" in sys.modules,
                  "executed": [f"{p}/{t}" for p, t in done]}))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_pair(root: Path) -> list[dict]:
    """Both processes of one pass; their last output lines, by rank."""
    script = root / "worker.py"
    script.write_text(WORKER)
    coord = f"localhost:{_free_port()}"
    env = {**os.environ, "PYTHONPATH": str(REPO), "CUDA_VISIBLE_DEVICES": ""}
    procs = [subprocess.Popen([sys.executable, str(script), coord, str(pid), str(root)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for pid in range(2)]
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
            results.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return results


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    root = tmp_path_factory.mktemp("two_process_grid")
    for k, job in enumerate(JOBS):
        plate, t = job.split("/")
        load_data, paths = make_fake_plate(
            str(root / plate / t), n_wells=2, image_size=64, channels=("DNA", "GFP"),
            cells_per_site=3, cell_radius=5, timepoint=t, plate=plate, seed=100 + k)
        for i, r in load_data.iterrows():
            np.save(root / plate / t / f"mask_{i}.npy",
                    paths["gt_masks"][(r["Metadata_Well"], r["Metadata_Site"])])
    return root


def test_two_processes_split_the_grid_and_resume(grid):
    first = _run_pair(grid)
    assert [r["pid"] for r in first] == [0, 1]
    assert not any(r["jax"] for r in first)
    ex0, ex1 = set(first[0]["executed"]), set(first[1]["executed"])
    assert ex0 and ex1 and not (ex0 & ex1) and ex0 | ex1 == set(JOBS)
    # rank r takes the jobs at r, r + 2, r + 4 of the grid's order
    assert first[0]["executed"] == JOBS[0::2] and first[1]["executed"] == JOBS[1::2]
    out = grid / "out"
    manifest = pd.read_json(out / "manifest.jsonl", lines=True)
    assert sorted(manifest["unit"]) == sorted(JOBS) and (manifest["n_sites"] == 2).all()
    tables = sorted(out.glob("P*/*/*.csv"))
    assert len(tables) == 4 * len(JOBS)
    for path in tables:
        table = pd.read_csv(path)
        plate, t = path.parent.parent.name, path.parent.name
        # the fixture's cells are their nuclei: Cytoplasm tables hold no rows
        assert len(table) > 0 or path.stem == "Cytoplasm", path
        assert set(table["Metadata_Plate"]) <= {plate}, path
        assert set(table["Metadata_Timepoint"].astype(str)) <= {t}, path
    stamp = {p: p.stat().st_mtime_ns for p in tables + [out / "manifest.jsonl"]}

    again = _run_pair(grid)
    assert [r["executed"] for r in again] == [[], []]
    assert {p: p.stat().st_mtime_ns for p in stamp} == stamp
    assert sorted(out.glob("P*/*/*.csv")) == tables
