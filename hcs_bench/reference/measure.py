"""The reference's measurement: the frozen plain copy of the port's
``measure_site_batch`` (``reference/plain/pipeline/features.py``) over the
reference's own labels, in blocks of sites."""

from __future__ import annotations

import numpy as np
import torch

from hcs_bench.reference.plain.pipeline.features import FeatureConfig, measure_site_batch


def feature_config(cfg: dict) -> FeatureConfig:
    return FeatureConfig(channels=tuple(cfg["channels"]), **cfg["features"])


@torch.no_grad()
def measure(images: np.ndarray, labels: np.ndarray, cfg: dict, device, block: int = 8) -> list[dict]:
    """(B, H, W, C) integer planes + (B, H, W) nuclei labels -> one
    {'Image', 'Nuclei', 'Cells', 'Cytoplasm'} table dict a site, measured
    ``block`` sites at a time."""
    fcfg = feature_config(cfg)
    out = []
    for s in range(0, len(images), block):
        out += measure_site_batch(images[s : s + block], labels[s : s + block], fcfg,
                                  image_numbers=list(range(s + 1, min(s + block, len(images)) + 1)),
                                  device=device)
    return out
