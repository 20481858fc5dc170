"""A cell of BENCHMARK.json cut to a size the CPU runs in seconds: 2 sites
of 360² a batch (3 x 3 nuclei), 2 distinct batches, max_cells 64; an
embedding box of 64 and a network input of 64² (the published widths
kept); a job of both batches."""

from __future__ import annotations

import copy

TINY_TRAFFIC = {"sites_per_batch": 2, "distinct_batches": 2, "size": 360}
TINY_ENGINE = {"max_cells": 64, "box_size": 64, "embed_size": 64, "embed_chunk": 16}


def tiny(spec: dict) -> dict:
    """A copy of a ``run.load_cell`` spec at the tiny size."""
    s = copy.deepcopy(spec)
    s["traffic"].update({k: v for k, v in TINY_TRAFFIC.items() if k in s["traffic"]
                         or k in ("sites_per_batch", "distinct_batches", "size")})
    eng = s["config"]["engine"]
    eng.update({k: v for k, v in TINY_ENGINE.items() if k in eng})
    if "features" in s["config"]:
        s["config"]["features"]["max_cells"] = TINY_ENGINE["max_cells"]
    if "job_sites" in s["config"]:  # the job: every distinct batch
        s["config"]["job_sites"] = TINY_TRAFFIC["sites_per_batch"] * TINY_TRAFFIC["distinct_batches"]
    if "calibration_crops" in s["config"]["weights"]:
        s["config"]["weights"]["calibration_crops"] = 4
    return s
