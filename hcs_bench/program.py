"""The system under test: ``saguaro_tpu_torch``'s segment-embed engine and
measurement, built from a configuration file and driven through the
measured window. The only module of the benchmark that imports the
program."""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch
from torch.profiler import record_function

from saguaro_tpu_torch.models.cellpose import CellposeConfig
from saguaro_tpu_torch.models.effnetv2 import EffNetV2Config, StageSpec
from saguaro_tpu_torch.pipeline.features import (
    FeatureConfig,
    measure_site_batch_dispatch,
    measure_site_batch_finalize,
)
from saguaro_tpu_torch.pipeline.segment_embed import SegmentEmbedConfig, SegmentEmbedEngine

ENGINE_KEYS = ("diameter", "max_cells", "cellprob_threshold", "flow_iters", "flow_error_threshold",
               "fill_holes", "min_size", "site_batch", "box_size", "embed_size", "embed_chunk",
               "fold_bn", "fold_rgb_stem")


def build_engine(cfg: dict, cellpose_state: dict, effnet_state: dict | None, device) -> SegmentEmbedEngine:
    """The engine as the configuration states it, with the benchmark's
    weights."""
    cp = CellposeConfig(**dict(cfg["cellpose"], features=tuple(cfg["cellpose"]["features"])))
    kw = {k: v for k, v in cfg["engine"].items() if k in ENGINE_KEYS}
    if "effnet" in cfg:
        e = cfg["effnet"]
        kw["effnet"] = EffNetV2Config(
            stem_filters=e["stem_filters"], head_filters=e["head_filters"], input_size=e["input_size"],
            compute_dtype=e["compute_dtype"], stages=tuple(StageSpec(*s) for s in e["stages"]))
    return SegmentEmbedEngine(SegmentEmbedConfig(channels=list(cfg["channels"]), cellpose=cp, **kw),
                              cellpose_state_dict=cellpose_state, effnet_state_dict=effnet_state,
                              seed=0, device=device)


def feature_config(cfg: dict) -> FeatureConfig:
    return FeatureConfig(channels=tuple(cfg["channels"]), **cfg["features"])


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Window:
    """What one pass over the window saw: its host-clock edges, the sites
    completed and failed, the benchmark-side spans (seconds, summed), and
    the sampled batch's inputs and outputs for the check. Spans are kept
    only while ``recording``; ``span_sites``, ``span_crops`` and
    ``span_t0`` are the sites completed, the crops embedded and the start
    of that stretch. ``t_clock`` is what the
    window's ``seconds`` count from."""

    t_start: float = 0.0
    t_end: float = 0.0
    t_clock: float = 0.0
    sites: int = 0
    failed: int = 0
    batches: int = 0
    crops: int = 0
    recording: bool = True
    span_sites: int = 0
    span_crops: int = 0
    span_t0: float = 0.0
    spans: dict = field(default_factory=dict)
    calls: dict = field(default_factory=dict)
    batch_ends: list = field(default_factory=list)
    sample_batch: int = -1
    sample_input: int = -1
    sample_labels: np.ndarray | None = None
    sample_outputs: list | None = None

    def add_span(self, name: str, seconds: float) -> None:
        self.calls[name] = self.calls.get(name, 0) + 1
        if self.recording:
            self.spans[name] = self.spans.get(name, 0.0) + seconds

    def start_spans(self, now: float) -> None:
        """Spans are kept from here on, and the window's seconds count from
        here."""
        self.recording, self.span_t0, self.t_clock = True, now, now


class Spans:
    """Host-clock spans around calls into the program's layers, each a
    ``bench/<name>`` range in a trace; with ``synced`` each ends in a
    device sync, so that it holds its layer's device work."""

    def __init__(self, window: Window, device, synced: bool):
        self.window, self.device, self.synced = window, device, synced

    def __call__(self, name: str, fn, *args, **kw):
        t0 = time.perf_counter()
        with record_function(f"bench/{name}"):
            out = fn(*args, **kw)
            if self.synced:
                sync(self.device)
        self.window.add_span(name, time.perf_counter() - t0)
        return out


def _site_failed_tables(tables: dict) -> bool:
    return len(tables.get("Nuclei", ())) == 0


def features_window(engine, fcfg: FeatureConfig, batches: list, seconds: float, sample_k: int,
                    synced: bool, after_batch=None, recording: bool = True) -> Window:
    """Closed loop of feature extraction: each batch from host numpy through
    ``segment_batch`` and ``measure_site_batch_dispatch``; the previous
    batch is finalized (its four tables built) after the next one is
    dispatched, as ``run_feature_extraction_job`` does. With ``synced``
    each batch is finalized before the next is dispatched and every span
    ends in a sync. Batches are dispatched until ``seconds`` have passed
    (and the sampled batch ``sample_k`` has been); the window closes when
    the batch in flight is finalized. ``after_batch(window)`` runs after
    each finalize; spans are kept from the start, or, with ``recording``
    False, from a batch dispatched after ``window.start_spans``."""
    w = Window(sample_batch=sample_k, recording=recording)
    span = Spans(w, engine.device, synced)
    pending = None

    def finalize(item):
        k, n, handle, kept = item
        tables = span("measure.finalize", measure_site_batch_finalize, handle)
        w.sites += n
        w.span_sites += n if kept else 0
        w.failed += n - len(tables) + sum(_site_failed_tables(t) for t in tables)
        w.batches += 1
        w.batch_ends.append(time.perf_counter())
        if k == w.sample_batch:
            w.sample_outputs = tables
        if after_batch is not None:
            after_batch(w)

    w.t_start = w.t_clock = w.span_t0 = time.perf_counter()
    k = 0
    while True:
        images = batches[k % len(batches)]
        kept = w.recording
        labels = span("segment", engine.segment_batch, images)
        lab = torch.stack(labels)
        if k == w.sample_batch:
            w.sample_input, w.sample_labels = k % len(batches), lab.cpu().numpy()
        handle = span("measure.dispatch", measure_site_batch_dispatch, images, lab, fcfg,
                      device=engine.device)
        del labels, lab
        if pending is not None:
            finalize(pending)
        pending = (k, len(images), handle, kept)
        if synced:
            finalize(pending)
            pending = None
        k += 1
        if time.perf_counter() - w.t_clock >= seconds and k > w.sample_batch:
            break
    if pending is not None:
        finalize(pending)
    w.t_end = time.perf_counter()
    return w


def embed_window(engine, batches: list, seconds: float, sample_k: int, synced: bool,
                 after_batch=None, recording: bool = True) -> Window:
    """Closed loop of segment-and-embed: each batch from host numpy through
    ``process_site_batch`` (segment, then pooled crops and embeddings back
    on the host), until ``seconds`` have passed (and the sampled batch
    ``sample_k`` has run); the window closes when the batch in flight
    returns. Spans as in ``features_window``."""
    w = Window(sample_batch=sample_k, recording=recording)
    span = Spans(w, engine.device, synced)
    segment, embed = engine.segment_batch, engine.embed_sites_pooled
    state = {"k": 0}

    def timed_segment(images):
        labels = span("segment", segment, images)
        if state["k"] == w.sample_batch:
            w.sample_labels = torch.stack(labels).cpu().numpy()
        return labels

    engine.segment_batch = timed_segment
    engine.embed_sites_pooled = lambda images, labels: span("embed", embed, images, labels)
    try:
        w.t_start = w.t_clock = w.span_t0 = time.perf_counter()
        while True:
            k = state["k"]
            images = batches[k % len(batches)]
            n = len(images)
            kept = w.recording
            results = engine.process_site_batch(list(range(k * n, (k + 1) * n)), images)
            out = [results.get(i, {"status": "missing", "n_cells": 0}) for i in range(k * n, (k + 1) * n)]
            w.sites += n
            w.span_sites += n if kept else 0
            w.failed += sum(r["status"] != "success" for r in out)
            crops = sum(r["n_cells"] for r in out) * images.shape[-1]
            w.crops += crops
            w.span_crops += crops if kept else 0
            w.batches += 1
            w.batch_ends.append(time.perf_counter())
            if k == w.sample_batch:
                w.sample_input, w.sample_outputs = k % len(batches), out
            if after_batch is not None:
                after_batch(w)
            state["k"] = k + 1
            if time.perf_counter() - w.t_clock >= seconds and k >= w.sample_batch:
                break
        w.t_end = time.perf_counter()
    finally:
        del engine.segment_batch, engine.embed_sites_pooled
    return w


def warm(engine, fcfg, pipeline: str, images) -> None:
    """One batch of the cell's own shape through the path the window
    drives, so that nothing builds or compiles inside the window."""
    if pipeline == "features":
        lab = torch.stack(engine.segment_batch(images))
        measure_site_batch_finalize(measure_site_batch_dispatch(images, lab, fcfg, device=engine.device))
    else:
        engine.process_site_batch(list(range(len(images))), images)
    sync(engine.device)


class KernelRecorder:
    """While active, wraps the wrappers of the port's hand-written kernels
    (``kernels/segment_cuda``) and records each call's bytes and operations
    (``yardstick.WORK``) from its arguments' shapes. The two counts of
    pixels that K1 and K4 radial need are reduced on the device inside a
    ``bench/roofline_count`` range and read once, after the trace."""

    def __init__(self, work: dict):
        from saguaro_tpu_torch.kernels import segment_cuda

        self.sc, self.work, self.calls, self.real = segment_cuda, work, [], {}

    def __enter__(self):
        import inspect

        for name, fn in self.work.items():
            real = self.real[name] = getattr(self.sc, name)
            sig = inspect.signature(real)

            def call(*args, _name=name, _real=real, _sig=sig, _fn=fn, **kw):
                bound = _sig.bind(*args, **kw)
                bound.apply_defaults()
                vals = list(bound.arguments.values())
                extra = []
                if _name in ("seg_counts", "seg_radial_sums"):
                    with record_function("bench/roofline_count"):
                        lab = vals[0]
                        if _name == "seg_counts":
                            extra.append(((lab >= 0) & (lab < vals[3])).sum())
                        else:
                            extra.append(((lab > 0) & (vals[1] >= 0) & (vals[1] < vals[4])).sum())
                meta = [torch.empty_like(v, device="meta") if isinstance(v, torch.Tensor) else v
                        for v in vals]
                self.calls.append((_name, _fn, meta, extra))
                return _real(*args, **kw)

            setattr(self.sc, name, call)
        return self

    def __exit__(self, *exc):
        for name, real in self.real.items():
            setattr(self.sc, name, real)

    def totals(self) -> list[tuple[str, float, float]]:
        """(kernel, bytes, operations) of each recorded call."""
        counts = [c for _, _, _, extra in self.calls for c in extra]
        host = torch.stack(counts).cpu().tolist() if counts else []
        out, i = [], 0
        for name, fn, meta, extra in self.calls:
            got = host[i : i + len(extra)]
            i += len(extra)
            out.append((name, *fn(*meta, *got)))
        return out
