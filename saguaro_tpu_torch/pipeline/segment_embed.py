"""Segmentation + deep-embedding engine and ``run_pipeline`` (port of
``saguaro_tpu/pipeline/segment_embed.py``).

The reference's producer/consumer pipeline (Cellpose_GPU_s3fs.py:
producers :47-87, consumers :89-232, main :235-473): a thread pool
prefetches TIFFs with the illumination division on the host, and one
controller feeds same-shape site batches to the device:

  1. CPnet tiled inference -> flows + cellprob        (models/cellpose.py)
  2. flow recovery -> labels                          (kernels/flow_ode.py)
  3. fixed-box masked crops around centroids          (kernels/crops.py)
  4. per-channel EfficientNetV2 embeddings, in fixed chunks of crops
                                                      (models/effnetv2.py)
  5. optional XGBoost dead-cell scoring               (models/xgb.py)

A site batch goes through CPnet at the diameter-rescaled network
resolution, pointer-jumping flow recovery, cellpose's flow-error QC and
hole filling, and a nearest upsample of the labels back to the input
resolution. A single site (``segment``) takes the reference's single-site
path: Euler flow recovery, the flow-error QC, the nearest upsample, then
hole filling and the min-size filter at the input resolution.

Outputs keep the reference's contract:
  *_counts.csv                 per-site Cell_Count (+ Dead_Cells)
  *_coords.parquet             Cell_ID = {well}_{site}_cell{i}, Y/X, Is_Dead
  *_well_aggregated.parquet    (or *_filtered_well_aggregated.parquet)
                               mean_features per well + Cell_Count
  *_single_cell.parquet        exploded per-cell feature rows

Failure contract as the reference's: a per-site error yields an empty
result for that site, logged at ERROR, and the run continues
(Cellpose_GPU_s3fs.py:123-125,228-232).
"""

from __future__ import annotations

import io
import logging
import queue
import threading
from dataclasses import dataclass, field

import numpy as np
import pandas as pd
import torch

from saguaro_tpu_torch.device import on_device, resolve_device
from saguaro_tpu_torch.io import storage, tiff
from saguaro_tpu_torch.io.loaddata import filter_qc_passing, site_image_paths
from saguaro_tpu_torch.kernels.crops import gather_crops, in_bounds, label_centroids
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
from saguaro_tpu_torch.models.effnetv2 import (
    EFFNETV2_L,
    EffNetV2Config,
    fold_batchnorm,
    fold_rgb_stem,
    init_effnetv2,
    preprocess_crops,
)
from saguaro_tpu_torch.models.cellpose_weights import load_torch_cellpose
from saguaro_tpu_torch.models.checkpoint import NotACheckpoint, load_variables
from saguaro_tpu_torch.models.effnet_weights import load_torch_effnet
from saguaro_tpu_torch.models.xgb import XGBEnsemble
from saguaro_tpu_torch.parallel.mesh import Mesh, default_mesh_for, replicate, shard_batch
from saguaro_tpu_torch.pipeline.manifest import Manifest
from saguaro_tpu_torch.utils import timing
from saguaro_tpu_torch.utils.timing import StageTimer

logger = logging.getLogger("saguaro_tpu_torch.segment_embed")

__all__ = ["FEATURE_LENGTH", "SegmentEmbedConfig", "SegmentEmbedEngine", "run_pipeline"]

FEATURE_LENGTH = 1280  # embedding width (Cellpose_GPU_s3fs.py:29)
# The embedding network's memory format (its weights and each chunk's
# input): channels_last, whose bf16 chunk of 128 crops at 480² took 194 ms
# against NCHW's 266 ms on an NVIDIA H100 80GB HBM3 at 700 W
# (chip_smoke.time_memory_formats).
EMBED_MEMORY_FORMAT = torch.channels_last


@dataclass
class SegmentEmbedConfig:
    """The reference's engine settings, with its defaults."""

    channels: list[str] = field(default_factory=list)
    diameter: float = 100.0            # reference eval setting (:143)
    box_size: int = 200                # crop box (:30)
    max_cells: int = 512               # static per-site cell bound
    embed_chunk: int = 128             # crops per network call
    embed_size: int = 480              # model input resolution
    cellprob_threshold: float = 0.0
    flow_iters: int = 200
    flow_error_threshold: float | None = 0.4  # cellpose's bad-flow QC
    fill_holes: bool = True            # cellpose fills mask interior holes
    min_size: int = 15
    site_batch: int = 8                # sites per batched pass
    prefetch_workers: int = 8          # host I/O threads (producer role)
    filter_dead_cells: bool = False
    save_coords: bool = False
    single_cell: bool = False
    xgb_model_path: str | None = None
    # checkpoint files: the package's own format (``models/checkpoint``,
    # what ``cli/train_segmenter`` writes) or a torch file (cellpose's, timm's)
    cellpose_checkpoint: str | None = None
    effnet_checkpoint: str | None = None
    devices: int | None = None         # mesh size for default engines
                                       # (None = all visible, 1 = no mesh)
    fold_bn: bool = True               # fold inference BN into the conv weights
    fold_rgb_stem: bool = True         # gray crops: the stem takes one channel
    cellpose: CellposeConfig = field(default_factory=CellposeConfig)
    effnet: EffNetV2Config = field(default_factory=lambda: EFFNETV2_L)


def _read_checkpoint(path: str, model: torch.nn.Module, load_torch) -> dict:
    """A checkpoint file's state dict for ``model``, in the reference's
    order: the package's own format first, then a torch file
    (``load_torch``). A file in neither format raises ``ValueError``."""
    try:
        state_dict, _ = load_variables(path, model)
    except NotACheckpoint:
        state_dict = load_torch(path)
    logger.info("Loaded checkpoint %s", path)
    return state_dict


def _load_weights(model: torch.nn.Module, state_dict: dict, what: str) -> None:
    """Load ``state_dict`` into ``model``; BatchNorm's ``num_batches_tracked``
    may be absent, any other missing or unexpected key raises."""
    missing, unexpected = model.load_state_dict(state_dict, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise ValueError(f"{what} state dict mismatch: missing {missing}, unexpected {unexpected}")


class SegmentEmbedEngine:
    """Holds the CPnet, the EfficientNetV2 and the optional dead-cell
    classifier on ``device`` (CUDA unless the caller names one); segments
    and embeds site batches. With a ``mesh`` (``parallel.mesh``) it keeps
    one replica of each network a data device and shards site batches and
    crop chunks over them."""

    def __init__(
        self,
        cfg: SegmentEmbedConfig,
        cellpose_state_dict: dict | None = None,
        effnet_state_dict: dict | None = None,
        seed: int = 0,
        device: str | torch.device | None = None,
        mesh: Mesh | None = None,
    ):
        """``cellpose_state_dict``: CPnet weights in cellpose's key layout (a
        cellpose checkpoint, or ``models.cellpose_weights.cellpose_state_dict_from_flax``);
        ``effnet_state_dict``: unfolded EffNetV2 weights in timm's key layout
        (a timm checkpoint, or ``models.effnet_weights.effnet_state_dict_from_flax``).
        Without one, the config's checkpoint file is read (the package's own
        format first, then a torch file, as the reference reads them), and
        without that the network gets seeded random weights. The EffNetV2's BatchNorms and
        RGB stem are folded here, once, on ``device``, as the config says.

        ``mesh``: site batches are split over its 'data' axis, each shard
        run by a replica of the networks on its data device (the first one,
        ``device`` unless named, holds the engine's own copy), and the
        results gathered in site order on ``device``."""
        self.cfg = cfg
        self.mesh = mesh
        if device is None and mesh is not None:
            device = mesh.data_devices[0]
        self.device = resolve_device(device)
        self.cell_model = init_cellpose(cfg.cellpose, seed=seed, device=self.device)
        if cellpose_state_dict is None and cfg.cellpose_checkpoint:
            cellpose_state_dict = _read_checkpoint(cfg.cellpose_checkpoint, self.cell_model,
                                                   load_torch_cellpose)
        if cellpose_state_dict is not None:
            _load_weights(self.cell_model, cellpose_state_dict, "cellpose")
        self.cell_model = self.cell_model.to(self.device).eval()

        self.feat_model = init_effnetv2(cfg.effnet, seed=seed, device=self.device)
        if effnet_state_dict is None and cfg.effnet_checkpoint:
            effnet_state_dict = _read_checkpoint(cfg.effnet_checkpoint, self.feat_model,
                                                 load_torch_effnet)
        if effnet_state_dict is not None:
            _load_weights(self.feat_model, effnet_state_dict, "effnet")
        if cfg.fold_bn:
            fold_batchnorm(self.feat_model)
        if cfg.fold_rgb_stem:
            fold_rgb_stem(self.feat_model)
        self.feat_model.to(memory_format=EMBED_MEMORY_FORMAT)
        self._embed_in_ch = self.feat_model.conv_stem.weight.shape[1]
        self.xgb = (XGBEnsemble.from_json(cfg.xgb_model_path, device=self.device)
                    if cfg.xgb_model_path else None)
        if mesh is not None:
            self._cell_replicas = replicate(self.cell_model, mesh)
            self._feat_replicas = replicate(self.feat_model, mesh)
        else:
            self._cell_replicas, self._feat_replicas = [self.cell_model], [self.feat_model]

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
        errs = timing.fetch(errs, "flow_qc")
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

    def _shards(self, x: torch.Tensor) -> tuple[list[torch.Tensor], list[int]]:
        """A batch on the engine's device -> (one shard a replica, in site
        order; the real sites of each). With a mesh the batch is padded with
        blank sites to a multiple of the data axis and split over it."""
        if self.mesh is None:
            return [x], [x.shape[0]]
        b, n_data = x.shape[0], self.mesh.shape["data"]
        pad = (-b) % n_data
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        k = x.shape[0] // n_data
        real = [max(0, min(k, b - i * k)) for i in range(n_data)]
        return shard_batch(x, self.mesh).shards, real

    @torch.no_grad()
    def segment_batch(self, images) -> list[torch.Tensor]:
        """(B, H, W, C) raw site batch (numpy of any dtype, or a tensor) ->
        list of B (H, W) int32 label tensors on the engine's device.

        The network input is cellpose's default channel conversion (the
        first ``n_channels`` raw planes); flows and masks are computed at
        the rescaled network resolution (diameter -> diam_mean) with an
        area-scaled min-size, and labels are upsampled nearest (half-pixel
        centres, as ``jax.image.resize``) to the input resolution.

        With a mesh the batch is padded with blank sites to a multiple of
        its data axis, split over it, and every shard's network pass is
        queued on its device before any shard's mask recovery (which reads
        back to the host) starts; the labels come back in site order without
        the padding. The call is the span ``segment/batch``, the network
        pass ``segment/network`` and the mask recovery with its flow QC and
        hole filling ``segment/masks`` (``utils.timing``)."""
        with timing.span("segment/batch"):
            return self._segment_batch(images)

    def _segment_batch(self, images) -> list[torch.Tensor]:
        cfg = self.cfg
        x = self._to_device(images)
        h0, w0 = x.shape[1:3]
        shards, real = self._shards(x)
        nets = []
        with timing.span("segment/network"):
            for model, shard in zip(self._cell_replicas, shards):
                with on_device(shard.device):
                    net_in = convert_input(shard, cfg.cellpose.n_channels)
                    nets.append(segment_image_batch(model, net_in, cfg.cellpose,
                                                    diameter=cfg.diameter,
                                                    at_network_resolution=True))
        h1, w1 = nets[0][0].shape[2:]
        scale = (h1 * w1) / (h0 * w0)
        min_size_low = max(1, int(round(cfg.min_size * scale))) if cfg.min_size else 0
        labels_low = []
        with timing.span("segment/masks"):
            for (flows, cellprob), n_real in zip(nets, real):
                if n_real == 0:  # a shard of padding only
                    continue
                with on_device(flows.device):
                    low = compute_masks_batch(
                        flows, cellprob,
                        cellprob_threshold=cfg.cellprob_threshold,
                        n_iters=cfg.flow_iters,
                        min_size=min_size_low,
                    )
                    if cfg.flow_error_threshold is not None:
                        low = self._drop_bad_flow_masks_batch(low, flows / 5.0)
                labels_low += low[:n_real]
            del nets
            if cfg.fill_holes:
                labels_low = [fill_label_holes(np.asarray(lab)) for lab in labels_low]
        lab = torch.as_tensor(np.stack(labels_low).astype(np.int32), device=self.device)
        if (h1, w1) != (h0, w0):
            lab = resize_nearest(lab, (h0, w0))
        return list(lab)

    # ---------------- embedding ----------------

    @torch.no_grad()
    def process_site_batch(self, site_ids: list[int], images, timer: StageTimer | None = None
                           ) -> dict[int, dict]:
        """The consumer body: segment a same-shape site batch at once, then
        crop and embed every site's cells together. ``images`` is the raw
        (B, H, W, C) batch (numpy, or a tensor, preferably already on the
        device: segmentation, crops and embeddings all read that one copy).

        Errors degrade per site, logged at ERROR: a failed batched
        segmentation falls back to segmenting site by site, a failed pooled
        embed to embedding site by site, and a site that still fails comes
        back ``{"status": "empty", "n_cells": 0}``. Its stages ``segment``
        and ``embed`` go to ``timer``, else to the active recorder
        (``utils.timing.stage``)."""
        stage = timer.stage if timer is not None else timing.stage
        results: dict[int, dict] = {}
        try:
            with stage("segment"):
                images_dev = self._to_device(images)
                labels_list = self.segment_batch(images_dev)
        except Exception as e:
            logger.error("batched segmentation failed (%s); falling back per-site", e)
            images_dev = images
            labels_list = []
            for img in images:
                try:
                    labels_list.append(self.segment(img))
                except Exception as e2:
                    logger.error("segment failed: %s", e2)
                    labels_list.append(np.zeros(tuple(img.shape[:2]), np.int32))
        try:
            with stage("embed"):
                per_site = self.embed_sites_pooled(images_dev, labels_list)
        except Exception as e:
            logger.error("pooled embed failed (%s); falling back per-site", e)
            per_site = []
            for img, labels in zip(images_dev, labels_list):
                try:
                    per_site.append(self.embed_site(img, labels))
                except Exception as e2:
                    logger.error("embed failed: %s", e2)
                    per_site.append(self._empty(img.shape[-1]))
        # surface max_cells truncation: ids beyond the bound are absent from
        # the crops, so a dense site must be told apart from a clean one in
        # the logs. The maxima are reduced on the device and fetched once.
        n_segs = timing.fetch(torch.stack(
            [self._to_device(lab).max().to(torch.int64) for lab in labels_list]
        ), "label_maxima")
        for sid, n_seg, (feats, coords) in zip(site_ids, n_segs, per_site):
            try:
                n_trunc = max(0, int(n_seg) - (self.cfg.max_cells - 1))
                if n_trunc:
                    logger.warning(
                        "site %s: %d cells segmented but max_cells=%d — "
                        "%d cells dropped from embedding/measurement",
                        sid, int(n_seg), self.cfg.max_cells, n_trunc,
                    )
                if len(feats) == 0:
                    results[sid] = {"status": "empty", "n_cells": 0}
                    continue
                results[sid] = {
                    "status": "success",
                    "n_cells": len(feats),
                    "n_truncated": n_trunc,
                    "features": feats,
                    "coords": coords,
                    "is_dead": self.score_dead(feats),
                }
            except Exception as e:
                logger.error("site %s failed: %s", sid, e)
                results[sid] = {"status": "empty", "n_cells": 0}
        return results

    @staticmethod
    def _empty(n_ch: int):
        return np.zeros((0, n_ch, FEATURE_LENGTH), np.float32), np.zeros((0, 2), np.int64)

    @torch.no_grad()
    def embed_sites_pooled(self, images, labels_list) -> list[tuple[np.ndarray, np.ndarray]]:
        """Crops and embeddings of a whole same-shape site batch at once.

        The valid (cell, channel) crop slots of every site go into one list,
        cell-major and channel-minor (the reference embeds each cell's
        channels one after another, Cellpose_GPU_s3fs.py:177-182), padded to
        a multiple of ``embed_chunk`` (times the mesh's data axis) with
        repeats of slot 0 (discarded); with a mesh, consecutive chunks go to
        the data devices' replicas in turn.
        Each chunk's crops are gathered from the device-resident batch,
        masked, preprocessed and embedded, so peak memory stays O(chunk),
        never the (sites x max_cells x box² x C) pool. The slot list goes to
        the device once and the embeddings come back once: no host sync
        inside the chunk loop.

        Returns, per site, (features (n_i, C, 1280) f32, coords (n_i, 2)
        int64 [cy, cx]), cells in label order. The call is the span
        ``embed/pooled``; each chunk's crops ``embed/crops`` and its forward
        ``embed/network`` (``utils.timing``)."""
        with timing.span("embed/pooled"):
            return self._embed_sites_pooled(images, labels_list)

    def _embed_sites_pooled(self, images, labels_list) -> list[tuple[np.ndarray, np.ndarray]]:
        cfg = self.cfg
        dev = self.device
        images = self._to_device(images).float()
        b, h, w, n_ch = images.shape
        labels = torch.stack([self._to_device(lab).to(torch.int32) for lab in labels_list])
        cy, cx, cnt = label_centroids(labels, cfg.max_cells)
        valid = (cnt > 0) & in_bounds(cy, cx, h, w, cfg.box_size)
        valid_np, cy_np, cx_np = timing.fetch(torch.stack([valid.int(), cy, cx]).reshape(3, -1),
                                              "embed.slots")
        idx = np.flatnonzero(valid_np)
        if idx.size == 0:
            return [self._empty(n_ch) for _ in range(b)]
        slots = np.stack([
            np.repeat(idx // cfg.max_cells, n_ch),
            np.repeat(idx % cfg.max_cells, n_ch),
            np.tile(np.arange(n_ch), idx.size),
            np.repeat(cy_np[idx], n_ch),
            np.repeat(cx_np[idx], n_ch),
        ])
        n_flat = slots.shape[1]
        # with a mesh a step takes embed_chunk slots a data device
        ck, n_rep = cfg.embed_chunk, len(self._feat_replicas)
        n_pad = (-n_flat) % (ck * n_rep)
        if n_pad:
            slots = np.concatenate([slots, np.repeat(slots[:, :1], n_pad, axis=1)], axis=1)
        slots = torch.as_tensor(slots, dtype=torch.int64, device=dev)
        images_chw = images.permute(0, 3, 1, 2).contiguous()
        # the batch, its labels and the slot list once on each data device
        on_dev = {images_chw.device: (images_chw, labels, slots)}
        for model in self._feat_replicas:
            d = next(model.parameters()).device
            if d not in on_dev:
                on_dev[d] = (images_chw.to(d), labels.to(d), slots.to(d))
        feats = torch.empty((n_flat + n_pad, FEATURE_LENGTH), dtype=torch.float32, device=dev)
        for s in range(0, n_flat + n_pad, ck):
            model = self._feat_replicas[(s // ck) % n_rep]
            d = next(model.parameters()).device
            img_d, lab_d, slots_d = on_dev[d]
            with on_device(d):
                feats[s : s + ck] = self._embed_chunk(img_d, lab_d, slots_d[:, s : s + ck], model)
        feats = timing.fetch(feats[:n_flat], "embed.result").reshape(idx.size, n_ch, FEATURE_LENGTH)
        coords = np.stack([cy_np, cx_np], axis=-1).astype(np.int64)
        site_of = idx // cfg.max_cells
        return [(feats[site_of == i], coords[idx[site_of == i]]) for i in range(b)]

    def _embed_chunk(self, images_chw, labels, slots, model=None) -> torch.Tensor:
        """One chunk: (5, k) slots (site, label, channel, cy, cx) -> (k, 1280),
        by ``model`` (default: the engine's own network)."""
        with timing.span("embed/crops"):
            crops = gather_crops(images_chw, labels, *slots, box=self.cfg.box_size)
            x = preprocess_crops(crops, self.cfg.embed_size, n_channels=self._embed_in_ch)
        with timing.span("embed/network"):
            return (model or self.feat_model)(x.contiguous(memory_format=EMBED_MEMORY_FORMAT))

    def embed_site(self, image, labels) -> tuple[np.ndarray, np.ndarray]:
        """Crops and embeddings of one site: (features (n_cells, C, 1280) f32,
        coords (n_cells, 2) int64), the pooled path on a batch of one."""
        return self.embed_sites_pooled(self._to_device(image)[None], [labels])[0]

    def score_dead(self, features: np.ndarray) -> np.ndarray:
        """(n, C, 1280) -> bool dead flags (preds > 0.5, reference :216)."""
        if self.xgb is None or len(features) == 0:
            return np.zeros(len(features), dtype=bool)
        flat = torch.as_tensor(features.reshape(len(features), -1), device=self.device)
        return self.xgb.predict_dead(flat).cpu().numpy()

    def process_site(self, image) -> dict:
        """The full per-site result dict (the single-site consumer body)."""
        labels = self.segment(image)
        if labels.max() == 0:
            return {"status": "empty", "n_cells": 0}
        feats, coords = self.embed_site(image, labels)
        if len(feats) == 0:
            return {"status": "empty", "n_cells": 0}
        return {
            "status": "success",
            "n_cells": len(feats),
            "features": feats,
            "coords": coords,
            "is_dead": self.score_dead(feats),
        }


# ----------------------------------------------------------------------------
# Host prefetch (the producer role) + run_pipeline


def _prefetch_sites(tasks, illum, workers: int, out_queue: queue.Queue) -> None:
    """Thread pool reading each site's channel TIFFs (f32, divided by the
    channel's illumination function where its shape matches) into
    ``out_queue`` as (site id, (H, W, C) array, or None on failure)."""

    def load(task):
        site_id, paths = task
        try:
            chans = []
            for i, p in enumerate(paths):
                img = tiff.imread(p).astype(np.float32)
                if illum and illum[i] is not None and img.shape == illum[i].shape:
                    img = img / illum[i]
                chans.append(img)
            return site_id, np.stack(chans, axis=-1)
        except Exception as e:  # degrade per site, like the reference
            logger.error("prefetch failed on site %s: %s", site_id, e)
            return site_id, None

    sem = threading.Semaphore(workers * 2)

    def worker(task):
        out_queue.put(load(task))
        sem.release()

    def feeder():
        for t in tasks:
            sem.acquire()
            threading.Thread(target=worker, args=(t,), daemon=True).start()

    threading.Thread(target=feeder, daemon=True).start()


def run_pipeline(
    load_data: pd.DataFrame,
    data_base_path: str,
    cfg: SegmentEmbedConfig,
    out_data_path: str,
    engine: SegmentEmbedEngine | None = None,
    image_qc: pd.DataFrame | None = None,
    illum: list[np.ndarray | None] | None = None,
    spill_dir: str | None = None,
    device: str | torch.device | None = None,
) -> dict[str, str]:
    """End-to-end run, with Cellpose_GPU_s3fs.main's outputs.

    ``engine``: a built engine (else one is built from ``cfg`` on
    ``device``, CUDA unless the caller names one, with a mesh over every
    visible CUDA device, or ``cfg.devices`` of them, when there are
    several and ``device`` names no CPU and no one card:
    ``parallel.mesh.default_mesh_for``). ``spill_dir``: when
    set, each completed site's features, coords and flags are spilled as
    ``<key>.npz`` with a JSONL manifest (the reference's npz spill,
    Cellpose_GPU_s3fs.py:218-223, made restartable): a re-run with the same
    spill_dir loads completed sites from disk and computes only the rest.

    Returns {output kind: path written}.
    """
    outputs: dict[str, str] = {}
    if image_qc is not None:
        load_data = filter_qc_passing(load_data, image_qc)
    load_data = load_data.reset_index(drop=True)

    # Spill keys are content-based (well + site + filenames), not row
    # indices: a re-run whose QC filtering or row order differs must not
    # attach cached features to the wrong wells.
    def spill_key(idx: int) -> str:
        row = load_data.iloc[idx]
        parts = [str(row[c]) for c in ("Metadata_Well", "Metadata_Site") if c in row.index]
        parts += [str(row[c]) for c in load_data.columns if c.startswith("FileName_")]
        return "site_" + "_".join(parts).replace("/", "_") if parts else f"site_{idx}"

    manifest = None
    results: dict[int, dict] = {}
    if spill_dir:
        manifest = Manifest(storage.join(spill_dir, "sites.jsonl"))
        for idx in range(len(load_data)):
            key = spill_key(idx)
            info = manifest.info(key)
            if info is None:
                continue
            if info.get("status") == "empty":
                results[idx] = {"status": "empty", "n_cells": 0}
            else:
                data = np.load(io.BytesIO(storage.read_bytes(storage.join(spill_dir, f"{key}.npz"))))
                results[idx] = {
                    "status": "success",
                    "n_cells": int(info["n_cells"]),
                    "features": data["features"],
                    "coords": data["coords"],
                    "is_dead": data["is_dead"],
                }

    tasks = [
        (idx, site_image_paths(row, cfg.channels, data_base_path))
        for idx, row in load_data.iterrows()
        if idx not in results
    ]
    n_ch = len(cfg.channels)
    if engine is None and tasks:
        # the production default: site batches sharded over every visible
        # card (``cfg.devices`` overrides the count; 1 = one device)
        mesh = default_mesh_for(device, cfg.devices)
        if mesh is not None:
            logger.info("run_pipeline: sharding site batches over %d devices", mesh.size)
        engine = SegmentEmbedEngine(cfg, device=device, mesh=mesh)
    timer = StageTimer()

    def record(batch_results: dict[int, dict]):
        results.update(batch_results)
        if manifest is None:  # NB: an empty Manifest is falsy via __len__
            return
        for sid, r in batch_results.items():
            key = spill_key(sid)
            if r["status"] == "success":
                buf = io.BytesIO()
                np.savez_compressed(
                    buf, features=r["features"], coords=r["coords"], is_dead=r["is_dead"]
                )
                storage.write_bytes(storage.join(spill_dir, f"{key}.npz"), buf.getvalue())
            manifest.mark_done(key, status=r["status"], n_cells=r["n_cells"])

    q: queue.Queue = queue.Queue(maxsize=cfg.prefetch_workers * 2)
    _prefetch_sites(tasks, illum, cfg.prefetch_workers, q)

    # consume: bucket same-shape sites into device batches (consumer role).
    # One batch of ship-ahead: batch k+1's copy to the device (non-blocking,
    # from pinned memory) is started before batch k's compute, so it rides
    # under batch k's segment and embed instead of serializing with them.
    buckets: dict[tuple, list[tuple[int, np.ndarray]]] = {}
    pending: list[tuple[list[int], torch.Tensor]] = []

    def ship(batch: np.ndarray) -> torch.Tensor:
        host = torch.from_numpy(batch)
        if engine.device.type != "cuda":
            return host
        return host.pin_memory().to(engine.device, non_blocking=True)

    def run_pending():
        if not pending:
            return
        ids, imgs = pending.pop()
        try:
            record(engine.process_site_batch(ids, imgs, timer=timer))
        except Exception as e:  # degrade per site: a bad batch never kills the run
            logger.error("site batch %s failed (%s); recording empty results", ids, e)
            record({sid: {"status": "empty", "n_cells": 0} for sid in ids})

    def flush(shape_key):
        items = buckets.pop(shape_key, [])
        if not items:
            return
        ids = [sid for sid, _ in items]
        try:
            imgs = ship(np.stack([im for _, im in items]))
        except Exception as e:
            logger.error("site batch %s ship failed (%s); recording empty", ids, e)
            record({sid: {"status": "empty", "n_cells": 0} for sid in ids})
            return
        run_pending()  # compute batch k while k+1's copy is in flight
        pending.append((ids, imgs))

    for _ in range(len(tasks)):
        site_id, image = q.get()
        if image is None or image.shape[-1] != n_ch:
            record({site_id: {"status": "empty", "n_cells": 0}})
            continue
        key = image.shape
        buckets.setdefault(key, []).append((site_id, image))
        if len(buckets[key]) >= cfg.site_batch:
            flush(key)
    for key in list(buckets):
        flush(key)
    run_pending()
    if timer.count:
        timer.log_summary()

    # ---------------- result assembly (reference :326-471) ----------------
    site_features, site_coords, site_dead = [], [], []
    for i in range(len(load_data)):  # includes spill-resumed sites
        r = results[i]
        if r["status"] == "empty":
            site_features.append(np.zeros((0, n_ch, FEATURE_LENGTH), np.float32))
            site_coords.append(np.zeros((0, 2), np.int64))
            site_dead.append(np.array([], dtype=bool))
        else:
            site_features.append(r["features"])
            site_coords.append(r["coords"])
            site_dead.append(r["is_dead"])

    aggregated, counts, dead_counts = [], [], []
    for feats, flags in zip(site_features, site_dead):
        if len(feats) == 0:
            aggregated.append(np.zeros((n_ch, FEATURE_LENGTH), np.float32))
            counts.append(0)
            dead_counts.append(0)
        elif cfg.xgb_model_path and cfg.filter_dead_cells:
            alive = ~flags
            n_alive = int(alive.sum())
            aggregated.append(
                feats[alive].sum(axis=0) if n_alive else np.zeros((n_ch, FEATURE_LENGTH), np.float32)
            )
            counts.append(n_alive)
            dead_counts.append(int(flags.sum()))
        else:
            aggregated.append(feats.sum(axis=0))
            counts.append(len(feats))
            dead_counts.append(int(flags.sum()))

    load_data = load_data.copy()
    load_data["Cell_Count"] = counts
    if cfg.xgb_model_path:
        load_data["Dead_Cells"] = dead_counts
    counts_path = out_data_path.replace(".parquet", "_counts.csv")
    storage.write_csv(load_data, counts_path)
    outputs["counts"] = counts_path

    if cfg.save_coords:
        recs = []
        for i, (coords, flags) in enumerate(zip(site_coords, site_dead)):
            well = load_data.loc[i, "Metadata_Well"] if "Metadata_Well" in load_data.columns else str(i)
            site = load_data.loc[i, "Metadata_Site"] if "Metadata_Site" in load_data.columns else str(i)
            for k, (y, x) in enumerate(coords):
                recs.append({
                    "Cell_ID": f"{well}_{site}_cell{k}",
                    "Y_Center": int(y),
                    "X_Center": int(x),
                    "Is_Dead": bool(flags[k]) if len(flags) else False,
                })
        if recs:
            coords_path = out_data_path.replace(".parquet", "_coords.parquet")
            with storage.open_file(coords_path, "wb") as f:
                pd.DataFrame(recs).to_parquet(f, engine="pyarrow")
            outputs["coords"] = coords_path

    # well-level aggregation: mean of per-site feature sums / total cells
    agg = load_data.copy()
    agg["sum_features"] = list(aggregated)
    meta_keep = [c for c in ("Metadata_Timepoint", "Metadata_Plate") if c in agg.columns]
    agg_funcs = {"sum_features": lambda s: np.sum(np.stack(list(s.values)), axis=0), "Cell_Count": "sum"}
    for c in meta_keep:
        agg_funcs[c] = "first"
    well = agg.groupby("Metadata_Well").agg(agg_funcs).reset_index()
    well["mean_features"] = well.apply(
        lambda row: (row["sum_features"] / row["Cell_Count"]).tolist()
        if row["Cell_Count"] > 0
        else np.zeros((n_ch, FEATURE_LENGTH)).tolist(),
        axis=1,
    )
    well = well.drop(columns=["sum_features"])
    suffix = "_filtered_well_aggregated.parquet" if cfg.filter_dead_cells else "_well_aggregated.parquet"
    well_path = out_data_path.replace(".parquet", suffix)
    with storage.open_file(well_path, "wb") as f:
        well.to_parquet(f, engine="pyarrow")
    outputs["well_aggregated"] = well_path

    if cfg.single_cell:
        sc_path = out_data_path.replace(".parquet", "_single_cell.parquet")
        valid_idx = [i for i, f in enumerate(site_features) if len(f) > 0]
        if not valid_idx:
            with storage.open_file(sc_path, "wb") as f:
                load_data.to_parquet(f, engine="pyarrow")
        else:
            valid_sites = load_data.iloc[valid_idx].copy()
            repeats = [len(site_features[i]) for i in valid_idx]
            expanded = valid_sites.loc[valid_sites.index.repeat(repeats)].copy()
            expanded["Cell_Index"] = expanded.groupby(level=0).cumcount()
            stacked = np.concatenate([site_features[i] for i in valid_idx], axis=0)
            expanded["single_cell_features"] = list(stacked.reshape(stacked.shape[0], -1))
            if cfg.xgb_model_path:
                expanded["is_dead_cell"] = np.concatenate([site_dead[i] for i in valid_idx])
            if "Cell_Count" in expanded.columns:
                expanded = expanded.drop(columns=["Cell_Count"])
            with storage.open_file(sc_path, "wb") as f:
                expanded.to_parquet(f, engine="pyarrow", row_group_size=100_000)
        outputs["single_cell"] = sc_path

    return outputs
