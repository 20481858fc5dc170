"""Segmentation alone, as cellpose users run it over a plate to save the
masks: each batch through ``segment_batch``, its labels stacked and copied
to the host as int32 numpy. The check holds the masks against the
reference's segmentation by pixels (``labels_px_off``) and by objects
(``objects_off``)."""

from __future__ import annotations

import time

import numpy as np
import torch

from hcs_bench import check, program


def host_labels(labels: list) -> np.ndarray:
    """A batch's label tensors stacked and copied to the host: (B, H, W)
    int32 numpy."""
    return torch.stack(labels).to(torch.int32).cpu().numpy()


def window(engine, cfg: dict, batches: list, seconds: float, sample_k: int, synced: bool,
           after_batch=None, recording: bool = True) -> program.Window:
    """Closed loop of segmentation: each batch from host numpy through
    ``segment_batch`` and its masks to the host (``host_labels``), until
    ``seconds`` have passed (and the sampled batch ``sample_k`` has run);
    the window closes when the masks of the batch in flight are on the
    host. A site whose masks do not come back, or hold no object, has
    failed. Spans as in ``pipelines/features.window``."""
    w = program.Window(sample_batch=sample_k, recording=recording)
    span = program.Spans(w, engine.device, synced)
    w.t_start = w.t_clock = w.span_t0 = time.perf_counter()
    k = 0
    while True:
        images = batches[k % len(batches)]
        n = len(images)
        kept = w.recording
        labels = span("segment", engine.segment_batch, images)
        masks = span("labels.host", host_labels, labels)
        del labels
        w.sites += n
        w.span_sites += n if kept else 0
        w.failed += n - len(masks) + int(sum(not m.any() for m in masks))
        w.batches += 1
        w.batch_ends.append(time.perf_counter())
        if k == w.sample_batch:
            w.sample_input, w.sample_labels, w.sample_outputs = k % len(batches), masks, masks
        if after_batch is not None:
            after_batch(w)
        k += 1
        if time.perf_counter() - w.t_clock >= seconds and k > w.sample_batch:
            break
    w.t_end = time.perf_counter()
    return w


def batch(engine, cfg: dict, images: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """One batch segmented, its masks on the host: (masks, masks)."""
    masks = host_labels(engine.segment_batch(images))
    return masks, masks


def numbers(cfg: dict, images: np.ndarray, judged_labels: np.ndarray, judged, ref, seed: int,
            ref_labels: np.ndarray, control=None, detail: dict | None = None) -> dict[str, float]:
    """The judged side's masks (the program's on the host, which are its
    outputs, or the control's own segmentation) against the reference's:
    at the worst site, the larger of the shares of either side's objects
    with no partner at IoU 0.5 (``objects_off``). ``detail`` receives each
    site's share."""
    sites = check.objects_off_by_site(judged_labels, ref_labels)
    if detail is not None:
        detail["objects_off_by_site"] = sites
    return {"objects_off": float(sites.max()) if len(sites) else 1.0}
