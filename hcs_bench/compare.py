"""The check of a run's sampled batch: the reference works out again from
the batch's inputs and the benchmark's weights what the timed path
produced, and ``check``'s numbers measure the gaps. The segmentation and
the measurement families of ``reference/cp_measure`` are judged against
references written from cellpose's and CellProfiler's definitions
(``reference/cellpose_ref``, ``reference/cp_measure``); every table column
is also held against the frozen copy of the program's plain forms
(``reference/plain``), which catches a kernel that departs from its plain
form but shares the program's logic; the embeddings against the plain
copy of EfficientNetV2. The control is the reference in a lower precision
put in the program's place."""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from hcs_bench import check
from hcs_bench.reference import cellpose_ref, cp_measure
from hcs_bench.reference.embed import embed, kept_cells
from hcs_bench.reference.measure import measure
from hcs_bench.reference.plain.device import full_f32
from hcs_bench.reference.plain.models.effnetv2 import EffNetV2
from hcs_bench.reference.precision import bf16_planes, fp8_convolutions
from hcs_bench.traffic.generator import seed_sequence
from hcs_bench.weights import effnet_config

EMBED_SLOTS_PER_SITE = 32


@dataclasses.dataclass
class Side:
    """A reference pipeline in one precision: ``lower`` False is the
    configuration's reference (float32, TF32 off), True its control (the
    networks' convolutions in fp8, the measurement's planes in bfloat16)."""

    cfg: dict
    cp_state: dict
    ef_state: dict | None
    device: object
    lower: bool = False

    def precision(self):
        return fp8_convolutions() if self.lower else contextlib.nullcontext()

    def labels(self, images: np.ndarray) -> np.ndarray:
        dtype = torch.bfloat16 if self.lower else torch.float32
        with full_f32(), self.precision():
            return cellpose_ref.segment(images, self.cp_state, self.cfg["cellpose"], self.cfg["engine"],
                                        self.device, dtype)

    def tables(self, images: np.ndarray, labels: np.ndarray) -> list:
        planes = bf16_planes(images) if self.lower else images
        with full_f32():
            return measure(planes, labels, self.cfg, self.device)

    def own_tables(self, images: np.ndarray, labels: np.ndarray) -> list:
        planes = bf16_planes(images) if self.lower else images
        return cp_measure.measure(planes, labels, list(self.cfg["channels"]))

    @torch.no_grad()
    def embeddings(self, images, labels, slots: np.ndarray) -> np.ndarray:
        ef_cfg = effnet_config(self.cfg, "bfloat16" if self.lower else "float32")
        with torch.device(self.device):
            net = EffNetV2(ef_cfg)
        net.load_state_dict(self.ef_state, strict=False)
        eng = self.cfg["engine"]
        with full_f32(), self.precision():
            return embed(net.eval(), images, labels, slots, eng["box_size"], eng["embed_size"], self.device)


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


def numbers(cfg: dict, images: np.ndarray, judged_labels: np.ndarray, judged, ref: Side, seed: int,
            control: Side | None = None, detail: dict | None = None,
            cache: dict | None = None) -> dict[str, float]:
    """The check's numbers for one sampled batch. The judged side's labels
    against the reference's own segmentation; its tables (every column
    against the plain forms, ``table_col_off``; the families of
    ``cp_measure`` against it, ``table_own_off``), or the embeddings of a
    sample of its cells drawn from the seed, against what the reference
    works out from the same inputs over the judged side's labels (the
    judged side's output, read only to judge). ``judged``: the
    program's outputs for the batch (tables a site, or
    ``process_site_batch`` results a site); with ``control``, ignored: the
    control computes its own. ``detail`` (optional) receives the
    per-column shares or the gaps; ``cache`` (optional) keeps the
    reference's segmentation for another call on the same batch."""
    cache = {} if cache is None else cache
    if "labels" not in cache:
        cache["labels"] = ref.labels(images)
    out = {"labels_px_off": check.label_px_off(judged_labels, cache["labels"])}
    if cfg["pipeline"] == "features":
        want = ref.tables(images, judged_labels)
        got = control.tables(images, judged_labels) if control else judged
        offs = check.table_offs(got, want, *images.shape[1:3])
        out["table_col_off"] = max(offs.values()) if offs else 1.0
        own = ref.own_tables(images, judged_labels)
        own_offs = check.table_offs(got, own, *images.shape[1:3])
        out["table_own_off"] = max(own_offs.values()) if own_offs else 1.0
        if detail is not None:
            detail["columns"] = offs
            detail["own_columns"] = own_offs
    else:
        eng = cfg["engine"]
        kept = kept_cells(judged_labels, eng["max_cells"], eng["box_size"], ref.device)
        slots = embed_slots(kept, seed, images.shape[-1])
        want = ref.embeddings(images, judged_labels, slots)
        got = (control.embeddings(images, judged_labels, slots) if control
               else program_vectors(judged, slots))
        gaps = np.array([2.0 if g is None else float(check.embed_gaps(np.asarray(g, np.float64)[None],
                                                                       w[None].astype(np.float64))[0])
                         for g, w in zip(got, want)])
        out["embed_cos_gap"] = float(gaps.max()) if len(gaps) else 2.0
        if detail is not None:
            detail["gaps"] = gaps
    return out
