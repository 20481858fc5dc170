"""Segment-and-embed: each batch through ``process_site_batch``, segmented,
then the cells clear of the edge cut out and embedded a channel at a time,
embeddings back on the host. The check holds a sample of (cell, channel)
slots drawn from the seed against the reference's embedder over the same
crops (``embed_cos_gap``)."""

from __future__ import annotations

import time

import numpy as np
import torch

from hcs_bench import check, networks, program
from hcs_bench.reference.embed import embed, kept_cells
from hcs_bench.reference.plain.device import full_f32
from hcs_bench.traffic.generator import seed_sequence

EMBED_SLOTS_PER_SITE = 32


def window(engine, cfg: dict, batches: list, seconds: float, sample_k: int, synced: bool,
           after_batch=None, recording: bool = True) -> program.Window:
    """Closed loop of segment-and-embed: each batch from host numpy through
    ``process_site_batch`` (segment, then pooled crops and embeddings back
    on the host), until ``seconds`` have passed (and the sampled batch
    ``sample_k`` has run); the window closes when the batch in flight
    returns. Spans as in ``pipelines/features.window``."""
    w = program.Window(sample_batch=sample_k, recording=recording)
    span = program.Spans(w, engine.device, synced)
    segment, embed_pooled = engine.segment_batch, engine.embed_sites_pooled
    state = {"k": 0}

    def timed_segment(images):
        labels = span("segment", segment, images)
        if state["k"] == w.sample_batch:
            w.sample_labels = torch.stack(labels).cpu().numpy()
        return labels

    engine.segment_batch = timed_segment
    engine.embed_sites_pooled = lambda images, labels: span("embed", embed_pooled, images, labels)
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


def batch(engine, cfg: dict, images: np.ndarray) -> tuple[np.ndarray, list]:
    """One batch through ``process_site_batch``: (its labels, its result a
    site)."""
    seen = {}
    segment = engine.segment_batch

    def keep(x):
        seen["labels"] = segment(x)
        return seen["labels"]

    engine.segment_batch = keep
    try:
        res = engine.process_site_batch(list(range(len(images))), images)
    finally:
        del engine.segment_batch
    return torch.stack(seen["labels"]).cpu().numpy(), [res.get(i) for i in range(len(images))]


def embed_slots(kept: list, seed: int, n_ch: int) -> np.ndarray:
    """Up to EMBED_SLOTS_PER_SITE (cell, channel) slots a site, drawn from
    the seed among the cells the edge rule keeps: (k, 5) rows (site, label,
    channel, cy, cx)."""
    rng = seed_sequence(seed, 7)
    rows = []
    for s, site in enumerate(kept):
        pairs = [(i, c) for i in range(len(site)) for c in range(n_ch)]
        pick = rng.choice(len(pairs), size=min(EMBED_SLOTS_PER_SITE, len(pairs)), replace=False)
        for j in sorted(pick):
            i, c = pairs[j]
            rows.append((s, site[i][0], c, site[i][1], site[i][2]))
    return np.array(rows, np.int64).reshape(-1, 5)


def program_vectors(outputs: list, slots: np.ndarray) -> list:
    """The program's embedding of each slot, found by its site and centroid
    (None where the program has no such cell or no result for the site)."""
    index = []
    for out in outputs:
        ok = out is not None and out.get("status") == "success"
        index.append({(int(y), int(x)): i for i, (y, x) in enumerate(out["coords"])} if ok else {})
    vecs = []
    for s, _, c, y, x in slots:
        i = index[s].get((int(y), int(x))) if s < len(index) else None
        vecs.append(None if i is None else outputs[s]["features"][i, c])
    return vecs


def embeddings(side, images: np.ndarray, labels: np.ndarray, slots: np.ndarray) -> np.ndarray:
    """The side's embedder (its precision) over the slots' masked crops."""
    net = networks.load(side.cfg["embedder"])
    forward = net.forward(side.cfg, side.states[net.SECTION], side.device, side.lower)
    with full_f32():
        return embed(forward, images, labels, slots, side.cfg["engine"]["box_size"], side.device)


def numbers(cfg: dict, images: np.ndarray, judged_labels: np.ndarray, judged, ref, seed: int,
            ref_labels: np.ndarray, control=None, detail: dict | None = None) -> dict[str, float]:
    """The embeddings of a sample of the judged side's cells drawn from the
    seed (the program's, found by centroid, or with ``control`` the
    control's own) against the reference's over the same crops: the worst
    1 - cosine (``embed_cos_gap``; a slot with no embedding reads 2).
    ``detail`` receives the gaps."""
    eng = cfg["engine"]
    kept = kept_cells(judged_labels, eng["max_cells"], eng["box_size"], ref.device)
    slots = embed_slots(kept, seed, images.shape[-1])
    want = embeddings(ref, images, judged_labels, slots)
    got = embeddings(control, images, judged_labels, slots) if control else program_vectors(judged, slots)
    gaps = np.array([2.0 if g is None else float(check.embed_gaps(np.asarray(g, np.float64)[None],
                                                                   w[None].astype(np.float64))[0])
                     for g, w in zip(got, want)])
    if detail is not None:
        detail["gaps"] = gaps
    return {"embed_cos_gap": float(gaps.max()) if len(gaps) else 2.0}
