"""The window's arithmetic: a closed loop closed at a batch boundary, with
a fake engine on a fake clock (each call advances it by a fixed time)."""

from __future__ import annotations

import torch

from hcs_bench import program
from hcs_bench.pipelines import embed, features, segment

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
