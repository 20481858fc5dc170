"""Feature extraction: each batch segmented, then every CellProfiler
measurement family of the configuration's ``features`` on the labels,
four tables a site back on the host. The check holds every table column
against the frozen plain forms (``table_col_off``) and the families of
``reference/cp_measure`` against CellProfiler's definitions
(``table_own_off``)."""

from __future__ import annotations

import time

import numpy as np
import torch

from hcs_bench import check, program
from hcs_bench.reference import cp_measure
from hcs_bench.reference.measure import measure
from hcs_bench.reference.plain.device import full_f32
from hcs_bench.reference.precision import bf16_planes


def _site_failed_tables(tables: dict) -> bool:
    return len(tables.get("Nuclei", ())) == 0


def window(engine, cfg: dict, batches: list, seconds: float, sample_k: int, synced: bool,
           after_batch=None, recording: bool = True) -> program.Window:
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
    fcfg = program.feature_config(cfg)
    w = program.Window(sample_batch=sample_k, recording=recording)
    span = program.Spans(w, engine.device, synced)
    pending = None

    def finalize(item):
        k, n, handle, kept = item
        tables = span("measure.finalize", program.measure_site_batch_finalize, handle)
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
        handle = span("measure.dispatch", program.measure_site_batch_dispatch, images, lab, fcfg,
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


def batch(engine, cfg: dict, images: np.ndarray) -> tuple[np.ndarray, list]:
    """One batch segmented and measured: (labels, tables a site)."""
    lab = torch.stack(engine.segment_batch(images))
    tables = program.measure_site_batch_finalize(
        program.measure_site_batch_dispatch(images, lab, program.feature_config(cfg), device=engine.device))
    return lab.cpu().numpy(), tables


def reference_tables(side, images: np.ndarray, labels: np.ndarray) -> list:
    """The frozen plain forms' tables over ``labels``; the control measures
    image planes rounded to bfloat16."""
    planes = bf16_planes(images) if side.lower else images
    with full_f32():
        return measure(planes, labels, side.cfg, side.device)


def own_tables(side, images: np.ndarray, labels: np.ndarray) -> list:
    """CellProfiler's definitions' tables over ``labels``
    (``reference/cp_measure``)."""
    planes = bf16_planes(images) if side.lower else images
    return cp_measure.measure(planes, labels, list(side.cfg["channels"]))


def numbers(cfg: dict, images: np.ndarray, judged_labels: np.ndarray, judged, ref, seed: int,
            ref_labels: np.ndarray, control=None, detail: dict | None = None) -> dict[str, float]:
    """The judged side's tables (the program's, or with ``control`` the
    control's own) over its labels: every column against the plain forms
    (``table_col_off``), the families of ``cp_measure`` against it
    (``table_own_off``); the worst column's share of rows off. ``detail``
    receives the per-column shares."""
    out = {}
    want = reference_tables(ref, images, judged_labels)
    got = reference_tables(control, images, judged_labels) if control else judged
    offs = check.table_offs(got, want, *images.shape[1:3])
    out["table_col_off"] = max(offs.values()) if offs else 1.0
    own = own_tables(ref, images, judged_labels)
    own_offs = check.table_offs(got, own, *images.shape[1:3])
    out["table_own_off"] = max(own_offs.values()) if own_offs else 1.0
    if detail is not None:
        detail["columns"] = offs
        detail["own_columns"] = own_offs
    return out
