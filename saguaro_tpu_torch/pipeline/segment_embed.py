"""Segmentation engine (port of the segment half of
``saguaro_tpu/pipeline/segment_embed.py``).

A site batch goes through CPnet tiled inference at the diameter-rescaled
network resolution, pointer-jumping flow recovery, cellpose's flow-error
QC and hole filling, and a nearest upsample of the labels back to the
input resolution. A single site (``segment``) takes the reference's
single-site path: Euler flow recovery, the flow-error QC, the nearest
upsample, then hole filling and the min-size filter at the input
resolution. The embed half (crops + EfficientNetV2) comes in a later
slice: its methods raise ``NotImplementedError`` and the engine builds no
embedding network.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

import numpy as np
import torch

from saguaro_tpu_torch.device import resolve_device
from saguaro_tpu_torch.kernels.flow_ode import (
    compute_masks,
    compute_masks_batch,
    fill_label_holes,
    flow_qc_error_batch,
    relabel_consecutive,
)
from saguaro_tpu_torch.models.cellpose import (
    CellposeConfig,
    convert_input,
    init_cellpose,
    resize_nearest,
    segment_image,
    segment_image_batch,
)

logger = logging.getLogger("saguaro_tpu_torch.segment_embed")

__all__ = ["SegmentEmbedConfig", "SegmentEmbedEngine"]


@dataclass
class SegmentEmbedConfig:
    """The reference's engine settings that the segment half reads, with the
    same defaults (the embed settings come with the embed slice)."""

    channels: list[str] = field(default_factory=list)
    diameter: float = 100.0            # reference eval setting
    max_cells: int = 512               # static per-site cell bound
    cellprob_threshold: float = 0.0
    flow_iters: int = 200
    flow_error_threshold: float | None = 0.4  # cellpose's bad-flow QC
    fill_holes: bool = True            # cellpose fills mask interior holes
    min_size: int = 15
    site_batch: int = 8                # sites per batched pass
    cellpose: CellposeConfig = field(default_factory=CellposeConfig)


class SegmentEmbedEngine:
    """Holds the CPnet and segments site batches on ``device`` (CUDA
    unless the caller names one)."""

    def __init__(
        self,
        cfg: SegmentEmbedConfig,
        cellpose_state_dict: dict | None = None,
        seed: int = 0,
        device: str | torch.device | None = None,
    ):
        """``cellpose_state_dict``: CPnet weights in cellpose's key layout (a
        cellpose checkpoint, or ``models.weights.cellpose_state_dict_from_flax``);
        without one the network gets seeded random weights."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.cell_model = init_cellpose(cfg.cellpose, seed=seed, device=self.device)
        if cellpose_state_dict is not None:
            missing, unexpected = self.cell_model.load_state_dict(
                cellpose_state_dict, strict=False
            )
            missing = [k for k in missing if not k.endswith("num_batches_tracked")]
            if missing or unexpected:
                raise ValueError(
                    f"cellpose state dict mismatch: missing {missing}, unexpected {unexpected}"
                )
        self.cell_model = self.cell_model.to(self.device).eval()

    # ---------------- segmentation ----------------

    @torch.no_grad()
    def segment(self, image) -> np.ndarray:
        """(H, W, C) raw site (numpy of any dtype, or a tensor) -> int32
        label mask, as the reference's single-site path: the network at the
        rescaled resolution, Euler mask recovery with no size filter, the
        flow-error QC, a nearest upsample to the input resolution, hole
        filling, then the min-size filter and a consecutive relabeling."""
        cfg = self.cfg
        x = self._to_device(image)
        net_in = convert_input(x, cfg.cellpose.n_channels)
        flows, cellprob, _ = segment_image(
            self.cell_model, net_in, cfg.cellpose, diameter=cfg.diameter,
            at_network_resolution=True,
        )
        labels_low = compute_masks(
            flows, cellprob,
            cellprob_threshold=cfg.cellprob_threshold,
            n_iters=cfg.flow_iters,
            min_size=0,  # the min-size filter runs at the input resolution below
        )
        if cfg.flow_error_threshold is not None:
            labels_low = self._drop_bad_flow_masks(labels_low, flows / 5.0)
        h0, w0 = x.shape[:2]
        labels = np.asarray(labels_low)
        if labels.shape != (h0, w0):
            low = torch.as_tensor(labels.astype(np.int32))[None]
            labels = resize_nearest(low, (h0, w0))[0].numpy()
        if cfg.fill_holes:
            labels = fill_label_holes(labels)
        return relabel_consecutive(labels, min_size=cfg.min_size)

    def _to_device(self, images) -> torch.Tensor:
        """Raw images (numpy of any dtype, or a tensor) on the engine's
        device; uint16 widens to int32 on the host."""
        if isinstance(images, torch.Tensor):
            return images.to(self.device)
        arr = np.asarray(images)
        if arr.dtype == np.uint16:
            arr = arr.astype(np.int32)
        return torch.as_tensor(arr, device=self.device)

    def _drop_bad_flow_masks_batch(
        self, labels_list: list[np.ndarray], flows: torch.Tensor
    ) -> list[np.ndarray]:
        """Cellpose's flow-error QC over a batch: remove masks whose shape
        disagrees with the predicted flow field (error > threshold), then
        relabel. One device pass scores every site; the LUT filtering
        stays on the host."""
        labels_arr = np.stack([np.asarray(lab) for lab in labels_list])
        maxes = labels_arr.reshape(len(labels_list), -1).max(axis=1)
        if not (maxes > 0).any():
            return [labels_arr[i] for i in range(len(labels_list))]
        errs, _ = flow_qc_error_batch(
            torch.as_tensor(labels_arr.astype(np.int32), device=flows.device),
            flows.float(),
            max_cells=self.cfg.max_cells,
        )
        errs = errs.cpu().numpy()
        out = []
        for i in range(len(labels_list)):
            lab, n = labels_arr[i], int(maxes[i])
            if n == 0:
                out.append(lab)
                continue
            err = errs[i]
            bad = np.where((err > self.cfg.flow_error_threshold) & (np.arange(len(err)) > 0))[0]
            bad = bad[bad <= n]
            if bad.size == 0:
                out.append(lab)
                continue
            lut = np.arange(n + 1, dtype=lab.dtype)
            lut[bad] = 0
            out.append(relabel_consecutive(lut[lab]))
        return out

    def _drop_bad_flow_masks(self, labels: np.ndarray, flows: torch.Tensor) -> np.ndarray:
        """Single-site ``_drop_bad_flow_masks_batch``: (H, W) + (2, H, W)."""
        return self._drop_bad_flow_masks_batch([labels], flows[None])[0]

    @torch.no_grad()
    def segment_batch(self, images) -> list[torch.Tensor]:
        """(B, H, W, C) raw site batch (numpy of any dtype, or a tensor) ->
        list of B (H, W) int32 label tensors on the engine's device.

        The network input is cellpose's default channel conversion (the
        first ``n_channels`` raw planes); flows and masks are computed at
        the rescaled network resolution (diameter -> diam_mean) with an
        area-scaled min-size, and labels are upsampled nearest (half-pixel
        centres, as ``jax.image.resize``) to the input resolution.
        """
        cfg = self.cfg
        x = convert_input(self._to_device(images), cfg.cellpose.n_channels)
        flows, cellprob = segment_image_batch(
            self.cell_model, x, cfg.cellpose, diameter=cfg.diameter,
            at_network_resolution=True,
        )
        h1, w1 = flows.shape[2:]
        h0, w0 = x.shape[1:3]
        scale = (h1 * w1) / (h0 * w0)
        min_size_low = max(1, int(round(cfg.min_size * scale))) if cfg.min_size else 0
        labels_low = compute_masks_batch(
            flows, cellprob,
            cellprob_threshold=cfg.cellprob_threshold,
            n_iters=cfg.flow_iters,
            min_size=min_size_low,
        )
        if cfg.flow_error_threshold is not None:
            labels_low = self._drop_bad_flow_masks_batch(labels_low, flows / 5.0)
        if cfg.fill_holes:
            labels_low = [fill_label_holes(np.asarray(lab)) for lab in labels_low]
        lab = torch.as_tensor(np.stack(labels_low).astype(np.int32), device=self.device)
        if (h1, w1) != (h0, w0):
            lab = resize_nearest(lab, (h0, w0))
        return list(lab)

    # ---------------- embedding (a later slice) ----------------

    def embed_site(self, *args, **kwargs):
        raise NotImplementedError("the embed half of the engine is not ported yet")

    def embed_sites_pooled(self, *args, **kwargs):
        raise NotImplementedError("the embed half of the engine is not ported yet")

    def process_site_batch(self, *args, **kwargs):
        raise NotImplementedError("the embed half of the engine is not ported yet")
