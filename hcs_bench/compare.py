"""The check of a run's sampled batch: the reference works out again from
the batch's inputs and the benchmark's weights what the timed path
produced, and ``check``'s numbers measure the gaps. Every pipeline's labels
are judged against the reference's own segmentation
(``reference/cellpose_ref`` through the configuration's segmenter,
``networks/<name>.py``), and each pipeline's outputs by its own numbers
(``pipelines/<name>.numbers``). The control is the reference in a lower
precision put in the program's place."""

from __future__ import annotations

import dataclasses

import numpy as np

from hcs_bench import check, networks, pipelines
from hcs_bench.reference import cellpose_ref
from hcs_bench.reference.plain.device import full_f32


@dataclasses.dataclass
class Side:
    """A reference pipeline in one precision, over the benchmark's weights
    (``states``: a state dict a network section): ``lower`` False is the
    configuration's reference (float32, TF32 off), True its control (each
    network's lower precision, ``networks/<name>.forward``; the
    measurement's planes in bfloat16)."""

    cfg: dict
    states: dict
    device: object
    lower: bool = False

    def labels(self, images: np.ndarray) -> np.ndarray:
        net = networks.load(self.cfg["segmenter"])
        forward = net.forward(self.cfg, self.states[net.SECTION], self.device, self.lower)
        with full_f32():
            return cellpose_ref.segment(images, forward, self.cfg[net.SECTION], self.cfg["engine"],
                                        self.device)


def numbers(cfg: dict, images: np.ndarray, judged_labels: np.ndarray, judged, ref: Side, seed: int,
            control: Side | None = None, detail: dict | None = None,
            cache: dict | None = None) -> dict[str, float]:
    """The check's numbers for one sampled batch. The judged side's labels
    against the reference's own segmentation (``labels_px_off``), then the
    pipeline's numbers: its outputs against what the reference works out
    from the same inputs over the judged side's labels (the judged side's
    output, read only to judge). ``judged``: the program's outputs for the
    batch (``pipelines/<name>.window``'s); with ``control``, ignored: the
    control computes its own. ``detail`` (optional) receives the
    pipeline's per-column shares, gaps or per-site shares; ``cache``
    (optional) keeps the reference's segmentation for another call on the
    same batch."""
    cache = {} if cache is None else cache
    if "labels" not in cache:
        cache["labels"] = ref.labels(images)
    out = {"labels_px_off": check.label_px_off(judged_labels, cache["labels"])}
    out.update(pipelines.load(cfg["pipeline"]).numbers(cfg, images, judged_labels, judged, ref, seed,
                                                       cache["labels"], control, detail))
    return out
