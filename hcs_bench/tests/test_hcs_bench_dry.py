"""Each cell run end to end on the CPU at a tiny size (``tiny``): the
harness's look for a card skipped, the program on its plain forms, the
check against the reference. Then the timed path broken underneath, once
for each fault a cell can have, and the control in the program's place:
``correct`` has to come out false."""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import pytest
import torch

from hcs_bench import program, run
from hcs_bench.check import judge
from hcs_bench.compare import Side, numbers
from hcs_bench.pipelines import job, segment
from hcs_bench.tests.tiny import tiny
from hcs_bench.traffic.generator import seed_sequence

CPU = torch.device("cpu")
SPEC = json.loads((Path(run.ROOT) / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
# a seed whose checked batch is the window's second (index 1)
SEED = next(s for s in range(2**31, 2**31 + 100) if seed_sequence(s, 1).integers(0, run.SAMPLE_BATCHES) == 1)


JOB = "features.job_lzw_csv"
# the program's module that runs a job, whose calls the faults replace
JOB_MODULE = sys.modules[program.resolve(job.JOB).__module__]


def spec_of(cell: str) -> dict:
    """A cell's spec at the tiny size."""
    return tiny(run.load_cell(cell))


def dry(cell: str, trace: bool = False, seconds: float = 0.1) -> dict:
    return run.run_cell(spec_of(cell), SEED, seconds, trace, CPU, t0=time.perf_counter())


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct(cell):
    res = dry(cell)
    assert res["correct"], res["checked"]
    assert res["attempted"] >= 2 * 2 and res["failed"] == 0
    e2e = [m["name"] for m in spec_of(cell)["end_to_end"]]
    assert sorted(res["metrics"]) == sorted(e2e)
    assert all(v["value"] > 0 for k, v in res["metrics"].items() if k != "peak_mem_gib")
    assert list(res["checked"]) == list(spec_of(cell)["limits"])


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_its_spans(cell):
    res = dry(cell, trace=True)
    assert res["correct"]
    names = [m["name"] for m in spec_of(cell)["per_layer"]]
    # on the CPU only the benchmark's spans can be read; the trace's
    # metrics need the card's trace and are left out
    if cell == JOB:
        assert {"job.read.s_per_site", "job.write.s_per_site", "job.sites_per_s"} <= set(res["metrics"])
        assert all(v["value"] > 0 for v in res["metrics"].values())
    else:
        assert any(n.startswith("segment.s_per_site") for n in res["metrics"])
    assert set(res["metrics"]) <= set(names)


def stale_labels(monkeypatch):
    """A step that returns its state unchanged: segmentation hands back the
    labels of its first call for every batch."""
    real = program.SegmentEmbedEngine.segment_batch
    kept = {}

    def stale(self, images):
        if "labels" not in kept:
            kept["labels"] = real(self, images)
        return kept["labels"]

    monkeypatch.setattr(program.SegmentEmbedEngine, "segment_batch", stale)


def half_batch(monkeypatch):
    """Half of the batch left out: only the first half of the sites' results
    (tables, also inside a job; embeddings; masks on the host) come back."""
    finalize, process = program.measure_site_batch_finalize, program.SegmentEmbedEngine.process_site_batch
    monkeypatch.setattr(program, "measure_site_batch_finalize", lambda h: finalize(h)[: h.n_sites // 2])
    monkeypatch.setattr(JOB_MODULE, "measure_site_batch_finalize",
                        lambda h, **kw: finalize(h, **kw)[: h.n_sites // 2])
    host = segment.host_labels
    monkeypatch.setattr(segment, "host_labels", lambda labels: host(labels)[: len(labels) // 2])

    def half(self, ids, images, timer=None):
        out = process(self, ids, images)
        return {i: out[i] for i in ids[: len(ids) // 2]}

    monkeypatch.setattr(program.SegmentEmbedEngine, "process_site_batch", half)


def altered_answer(monkeypatch):
    """An answer altered where it is produced: the first site's nucleus
    areas each one pixel more (also inside a job), its embeddings with their
    signs flipped, or its first object's mask erased on the host."""
    finalize, process = program.measure_site_batch_finalize, program.SegmentEmbedEngine.process_site_batch
    host = segment.host_labels

    def altered_masks(labels):
        out = host(labels)
        out[0][out[0] == 1] = 0
        return out

    def altered_tables(h, **kw):
        out = finalize(h, **kw)
        out[0]["Nuclei"]["AreaShape_Area"] += 1
        return out

    def altered_embeddings(self, ids, images, timer=None):
        out = process(self, ids, images)
        first = out[ids[0]]
        first["features"] = -first["features"]
        return out

    monkeypatch.setattr(program, "measure_site_batch_finalize", altered_tables)
    monkeypatch.setattr(JOB_MODULE, "measure_site_batch_finalize", altered_tables)
    monkeypatch.setattr(program.SegmentEmbedEngine, "process_site_batch", altered_embeddings)
    monkeypatch.setattr(segment, "host_labels", altered_masks)


@pytest.mark.parametrize("fault", [stale_labels, half_batch, altered_answer], ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    res = dry(cell)
    assert not res["correct"], res["checked"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    """The control (the reference in the next lower precision, in the
    program's place) fails the cell's limits, at the tiny size."""
    spec = spec_of(cell)
    cfg = spec["config"]
    batches, states = run.inputs_and_weights(spec, SEED, CPU)
    ref = Side(cfg, states, CPU)
    low = Side(cfg, states, CPU, lower=True)
    nums = numbers(cfg, batches[1], low.labels(batches[1]), None, ref, SEED, control=low)
    ok, checked = judge(nums, spec["limits"])
    assert not ok, checked
