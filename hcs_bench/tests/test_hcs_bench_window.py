"""The window's arithmetic: a closed loop closed at a batch boundary, with
a fake engine on a fake clock (each call advances it by a fixed time)."""

from __future__ import annotations

import os
import tempfile

import numpy as np
import pandas as pd
import pytest
import torch

from hcs_bench import program
from hcs_bench.pipelines import embed, features, job, segment

CFG = {"channels": ["DNA"], "features": {}}


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def fake_features(monkeypatch, clock, sites=4, size=8):
    class Engine:
        device = torch.device("cpu")

        def segment_batch(self, images):
            clock.t += 1.0
            return [torch.full((size, size), len(images), dtype=torch.int32)] * len(images)

    def dispatch(images, lab, fcfg, device=None):
        clock.t += 0.5
        return len(images)

    def finalize(handle):
        clock.t += 0.25
        return [{"Nuclei": [1] if i else []} for i in range(handle)]

    monkeypatch.setattr(program.time, "perf_counter", clock)
    monkeypatch.setattr(program, "measure_site_batch_dispatch", dispatch)
    monkeypatch.setattr(program, "measure_site_batch_finalize", finalize)
    return Engine(), [torch.zeros((sites, size, size, 5)).numpy() for _ in range(2)]


def test_features_window_closes_after_the_batch_in_flight(monkeypatch):
    clock = Clock()
    engine, batches = fake_features(monkeypatch, clock)
    w = features.window(engine, CFG, batches, 5.0, 0, synced=False)
    # batch k dispatched at 1.5, 3.25 (after finalizing k-1), 5.0 >= 5: stop;
    # the last finalize closes the window at 5.25
    assert (w.batches, w.sites, w.failed) == (3, 12, 3)
    assert abs((w.t_end - w.t_start) - 5.25) < 1e-9
    assert abs(w.sites / (w.t_end - w.t_start) - 12 / 5.25) < 1e-12
    assert w.spans["segment"] == 3.0 and w.calls["measure.dispatch"] == 3
    assert abs(w.spans["measure.finalize"] - 0.75) < 1e-12


def test_features_window_runs_to_the_sampled_batch(monkeypatch):
    clock = Clock()
    engine, batches = fake_features(monkeypatch, clock)
    w = features.window(engine, CFG, batches, 0.1, 2, synced=False)
    assert w.batches == 3 and w.sample_input == 0 and w.sample_outputs is not None
    assert w.sample_labels.shape == (4, 8, 8)


def test_embed_window_rate(monkeypatch):
    clock = Clock()
    monkeypatch.setattr(program.time, "perf_counter", clock)

    class Engine:
        device = torch.device("cpu")

        def segment_batch(self, images):
            return [torch.zeros(2, 2)]

        def embed_sites_pooled(self, images, labels):
            return None

        def process_site_batch(self, ids, images):
            self.segment_batch(images)
            self.embed_sites_pooled(images, None)
            clock.t += 2.0
            return {i: {"status": "success" if i % 4 else "empty", "n_cells": 3} for i in ids}

    batches = [torch.zeros((4, 2, 2, 5)).numpy()]
    w = embed.window(Engine(), CFG, batches, 5.0, 1, synced=False)
    assert (w.batches, w.sites, w.failed, w.crops) == (3, 12, 3, 12 * 3 * 5)
    assert abs((w.t_end - w.t_start) - 6.0) < 1e-9
    assert w.sample_input == 0 and len(w.sample_outputs) == 4


def test_traced_stretch_keeps_spans_after_the_profiler(monkeypatch):
    """A traced run: synced, each batch finalized before the next; spans
    and the window's seconds count only from ``start_spans`` on (the
    profiler stopped after the first batch)."""
    clock = Clock()
    engine, batches = fake_features(monkeypatch, clock)

    def after_batch(w):
        if w.batches == 1:
            clock.t += 10.0  # the profiler's stop, outside the stretch
            w.start_spans(clock())

    w = features.window(engine, CFG, batches, 3.0, 0, synced=True, after_batch=after_batch,
                                recording=False)
    # batch 0 ends at 101.75; spans from 111.75: batches 1 and 2 (1.75 s each)
    assert (w.batches, w.sites, w.span_sites) == (3, 12, 8)
    assert w.spans["segment"] == 2.0 and abs(w.spans["measure.finalize"] - 0.5) < 1e-12
    assert abs(w.t_end - w.span_t0 - 3.5) < 1e-9 and w.calls["segment"] == 3


def test_segment_window_counts_the_masks_on_the_host(monkeypatch):
    """Each batch segmented and its masks copied to the host; a site with
    no object has failed; the window closes when the batch in flight is on
    the host."""
    clock = Clock()
    engine, batches = fake_features(monkeypatch, clock)
    w = segment.window(engine, CFG, batches, 2.5, 1, synced=False)
    # segment 1 s a batch: 101, 102, 103 >= 102.5 -> stop after the third
    assert (w.batches, w.sites, w.failed) == (3, 12, 0)
    assert abs((w.t_end - w.t_start) - 3.0) < 1e-9 and w.spans["segment"] == 3.0
    assert w.sample_input == 1 and w.sample_labels.dtype == "int32" and w.sample_labels.shape == (4, 8, 8)
    assert w.sample_outputs is w.sample_labels


def test_segment_window_fails_empty_and_missing_sites(monkeypatch):
    clock = Clock()
    engine, batches = fake_features(monkeypatch, clock)
    real = engine.segment_batch
    monkeypatch.setattr(engine, "segment_batch",
                        lambda images: [lab * 0 for lab in real(images)[:3]], raising=False)
    w = segment.window(engine, CFG, batches, 0.5, 0, synced=False)
    # one batch of 4: 3 masks back, all empty
    assert (w.batches, w.sites, w.failed) == (1, 4, 4)


def tiffs(root) -> int:
    """The TIFFs under a directory."""
    return sum(f.endswith(".tiff") for _, _, files in os.walk(root) for f in files)


def fake_job_program(monkeypatch, clock, no_nuclei=(2,)):
    """The program's job replaced by one that reads no TIFF but checks
    that each is on disk, segments its sites in batches through the job's
    segmenter, takes 0.5 s to read and 0.25 s to write on the fake clock
    (its own ``StageTimer``), and writes four CSVs in which the sites
    ``no_nuclei`` have no Nuclei row. Returns the calls' records."""
    calls = []
    real = program.resolve

    def run_job(load_data, image_path, output_path, channels, segmenter, feature_cfg, site_batch=8,
                device=None, timer=None):
        names = [f for ch in channels for f in load_data[f"FileName_{ch}"]]
        root = os.path.dirname(os.path.dirname(image_path))
        calls.append({"t": clock(), "out": output_path, "tiffs": tiffs(root),
                      "on_disk": all(os.path.exists(os.path.join(image_path, f)) for f in names)})
        n = len(load_data)
        for s in range(0, n, site_batch):
            segmenter.segment_batch(np.full((min(site_batch, n - s), 8, 8, len(channels)), s, np.uint16))
        with timer.stage("read"):
            clock.t += 0.5
        with timer.stage("write"):
            clock.t += 0.25
            os.makedirs(output_path, exist_ok=True)
            nums = list(range(1, n + 1))
            tables = {"Image": pd.DataFrame({"ImageNumber": nums, "Count_Nuclei": nums}),
                      "Nuclei": pd.DataFrame({"ImageNumber": [i for i in nums if i not in no_nuclei],
                                              "ObjectNumber": 1, "AreaShape_MaximumRadius": np.float32(0.1)}),
                      "Cells": pd.DataFrame({"ImageNumber": nums, "ObjectNumber": 1}),
                      "Cytoplasm": pd.DataFrame({"ImageNumber": nums, "ObjectNumber": 1})}
            out = {}
            for name, df in tables.items():
                out[name] = os.path.join(output_path, f"{name}.csv")
                df.to_csv(out[name], index=False)
        return out

    monkeypatch.setattr(program, "resolve", lambda path: run_job if path == job.JOB else real(path))
    return calls


def test_job_window_writes_the_tiffs_before_the_clock(monkeypatch, tmp_path):
    """The sites are written as TIFFs in set-up (``prepare``), none inside
    the window; the job runs again and again, each site of a returned run
    counts and one without Nuclei rows fails; the job's read and write stages are its
    spans; the sampled batch's rows come back from the sampled job's own
    CSVs, numbered from 1, at the precision written; the directory is gone
    after the window."""
    clock = Clock()
    monkeypatch.setattr(program.time, "perf_counter", clock)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    calls = fake_job_program(monkeypatch, clock)

    class Engine:
        device = torch.device("cpu")

        def segment_batch(self, images):
            clock.t += 1.0
            return [torch.full(images.shape[1:3], int(images[0, 0, 0, 0]) + 1, dtype=torch.int32)
                    for _ in images]

    traffic = {"plate": "P1", "timepoint": "24"}
    batches = [np.full((2, 8, 8, 2), k, np.uint16) for k in range(2)]
    cfg = {"channels": ["DNA", "ER"], "features": {}, "job_sites": 4}
    with pytest.raises(ValueError):
        job.prepare(dict(cfg, job_sites=6), traffic, batches)
    t0 = clock()
    files = job.prepare(cfg, traffic, batches)
    assert clock() == t0 and tiffs(files.root) == 2 * 2 * 2
    assert [np.array_equal(a, b) for a, b in zip(files, batches)] == [True] * 2
    from PIL import Image

    plane = np.asarray(Image.open(os.path.join(files.job[1], "A03_s1_ER.tiff")))  # batch 1
    assert plane.dtype == np.uint16 and (plane == 1).all()
    monkeypatch.setattr(program, "feature_config", lambda cfg: None)
    w = job.window(Engine(), cfg, files, 5.0, 1, synced=False)
    # a job: 2 batches of 1 s, read 0.5, write 0.25: 2.75 s; 5 s have passed after the second
    assert [c["tiffs"] for c in calls] == [8, 8] and all(c["on_disk"] for c in calls)
    assert (w.batches, w.sites, w.failed) == (2, 8, 2)
    assert abs((w.t_end - w.t_start) - 5.5) < 1e-9
    assert w.spans["job.read"] == 1.0 and w.spans["job.write"] == 0.5
    assert w.calls["job"] == 2 and abs(w.spans["job"] - 5.5) < 1e-9
    # sample_k 1: the first run's second batch, in a directory of its own
    assert calls[0]["out"].endswith("sample") and not calls[1]["out"].endswith("sample")
    assert w.sample_input == 1 and w.sample_labels.shape == (2, 8, 8) and (w.sample_labels == 3).all()
    first, second = w.sample_outputs
    assert list(first["Image"]["ImageNumber"]) == [1] and list(first["Image"]["Count_Nuclei"]) == [3]
    assert first["Nuclei"]["AreaShape_MaximumRadius"].iloc[0] == float(np.float32(0.1))
    assert list(second["Nuclei"]["ImageNumber"]) == [2]
    assert not os.path.exists(files.root)


def test_job_rate_reader_reads_the_stretch_after_the_profiler():
    """``job.sites_per_s``: the sites completed after the profiler over
    that stretch's seconds; nothing to read without sites or seconds."""
    from hcs_bench import run
    from hcs_bench.records import Run

    read = run.reader("job.sites_per_s")
    assert read(Run(traffic={}, sites=96, spans={"job": 60.0}, span_s=60.0)) == 1.6
    assert read(Run(traffic={}, sites=0, spans={}, span_s=60.0)) is None
    assert read(Run(traffic={}, sites=96, spans={}, span_s=0.0)) is None


def test_job_window_tables_of_a_missing_site(monkeypatch, tmp_path):
    """A site with no Image row comes back as None, and a column that is
    not all numbers stays text."""
    out = tmp_path / "out"
    out.mkdir()
    pd.DataFrame({"ImageNumber": [1, 3], "Metadata_Well": ["A01", "A03"], "x": [0.5, 1e-300]}).to_csv(
        out / "Image.csv", index=False)
    sites = job.site_tables(str(out), 0, 3)
    assert sites[1] is None and "Nuclei" not in sites[0]
    assert list(sites[2]["Image"]["Metadata_Well"]) == ["A03"] and sites[2]["Image"]["x"].iloc[0] == 1e-300


def test_job_batch_is_a_job_of_its_own(monkeypatch, tmp_path):
    """The warm batch (and the calibration's) is a job of its own over its
    batch's sites, written as TIFFs into a temporary directory that goes
    with it; it returns the labels of its one segmenter call and its rows a
    site."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    seen = []
    real = program.resolve

    def run_job(load_data, image_path, output_path, channels, segmenter, feature_cfg, site_batch=8,
                device=None, timer=None):
        seen.append((list(load_data["Metadata_Well"]), tiffs(image_path), site_batch))
        segmenter.segment_batch(np.zeros((len(load_data), 8, 8, len(channels)), np.uint16))
        os.makedirs(output_path)
        pd.DataFrame({"ImageNumber": range(1, len(load_data) + 1)}).to_csv(
            os.path.join(output_path, "Image.csv"), index=False)
        return {}

    monkeypatch.setattr(program, "resolve", lambda path: run_job if path == job.JOB else real(path))
    monkeypatch.setattr(program, "feature_config", lambda cfg: None)

    class Engine:
        device = torch.device("cpu")

        def segment_batch(self, images):
            return [torch.full(images.shape[1:3], 7, dtype=torch.int32) for _ in images]

    labels, tables = job.batch(Engine(), {"channels": ["DNA", "ER"]}, np.zeros((3, 8, 8, 2), np.uint16))
    assert seen == [(["A01", "A02", "A03"], 6, 3)]
    assert labels.shape == (3, 8, 8) and (labels == 7).all()
    assert [list(t["Image"]["ImageNumber"]) for t in tables] == [[1], [2], [3]]
    assert os.listdir(tmp_path) == []
