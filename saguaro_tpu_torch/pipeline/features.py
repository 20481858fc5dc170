"""Classical feature extraction — CellProfiler-equivalent measurements in
the Image/Nuclei/Cells/Cytoplasm table schema (port of
``saguaro_tpu/pipeline/features.py``).

Per site, nuclei labels are grown into Cells by CP's propagation race over
a globally thresholded cell-body stain, Cytoplasm is Cells minus Nuclei,
and every object set gets the fused shape / moment / Zernike / intensity /
edge / correlation families; the Image table gets the threshold, per-
channel intensity statistics and the granularity spectrum. A site batch is
measured at once: every tensor carries a leading batch dimension.

Every family of the reference's default FeatureConfig is ported: AreaShape
(base, moments, Zernike, radii, convex hull), Location, Intensity, edge
intensity and quantiles, Texture (Haralick), RadialDistribution (CP or
centroid binning), Neighbors, Correlation (Correlation, Slope, Overlap, K,
Manders, RWC, Costes), Granularity, image intensity and threshold columns,
with global or adaptive threshold scope and optional smoothing at
binarisation, and the second-level Costes descent (``costes_fine_scale``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import pandas as pd
import torch
from torch.profiler import record_function

from saguaro_tpu_torch.device import on_device, resolve_device
from saguaro_tpu_torch.kernels import segment_cuda as sc
from saguaro_tpu_torch.kernels.colocalization import _xla_cumsum, colocalization_features_multiset
from saguaro_tpu_torch.kernels.fused_measure import fused_object_features
from saguaro_tpu_torch.kernels.glcm import (
    HARALICK_NAMES,
    haralick_features,
    object_glcm_multichannel,
    quantize_channels,
)
from saguaro_tpu_torch.kernels.morphology import (
    expand_labels,
    granularity_spectrum_cp,
    propagate_labels,
    tertiary_objects,
)
from saguaro_tpu_torch.kernels.objects_extra import (
    neighbor_features,
    quantile_intensity_features_mc,
)
from saguaro_tpu_torch.kernels.onehot_reduce import mxu_take_t
from saguaro_tpu_torch.kernels.radial import cp_ring_wedge
from saguaro_tpu_torch.kernels.segment_reduce import _flat, euler_numbers
from saguaro_tpu_torch.kernels.shape_extra import (
    _label_edt_sq,
    convex_features,
    radius_features,
)
from saguaro_tpu_torch.kernels.thresholding import (
    adaptive_threshold,
    global_threshold,
    smooth_for_binarize,
)
from saguaro_tpu_torch.kernels.onehot_reduce import onehot_counts
from saguaro_tpu_torch.kernels.zernike import ZERNIKE_INDEXES
from saguaro_tpu_torch.parallel.mesh import Mesh, shard_batch

__all__ = [
    "FeatureConfig",
    "measure_site",
    "measure_site_batch",
    "measure_site_batch_dispatch",
    "measure_site_batch_finalize",
    "MeasureHandle",
    "otsu_threshold",
]


@dataclass(frozen=True)
class FeatureConfig:
    """Field for field the reference's FeatureConfig, with its defaults."""

    channels: tuple[str, ...]
    max_cells: int = 512
    glcm_levels: int = 16
    texture_scale: int = 3
    # 'propagation' = CP's cost-based label race; 'distance' = dilation.
    # iterations=None runs propagation to convergence (CP semantics)
    secondary_method: str = "propagation"
    secondary_regularization: float = 0.05
    secondary_iterations: int | None = None
    secondary_threshold_method: str = "otsu"   # 'otsu' | 'otsu3' | 'li'
    secondary_threshold_scope: str = "global"
    secondary_adaptive_window: int = 50
    secondary_threshold_log: bool = False
    secondary_otsu3_middle_foreground: bool = True
    secondary_threshold_smoothing: float = 0.0
    secondary_threshold_correction: float = 1.0
    secondary_threshold_lower: float = 0.0
    secondary_threshold_upper: float = 3.0e38
    granularity_length: int = 16
    granularity_subsample: float = 0.25
    granularity_bg_sample: float = 0.25
    granularity_element_size: int = 10
    measure_texture: bool = True
    measure_quantiles: bool = True
    measure_edge: bool = True
    measure_radial: bool = True
    measure_neighbors: bool = True
    measure_zernike: bool = True
    measure_radius: bool = True
    measure_convex: bool = True
    measure_moments: bool = True
    measure_colocalization: bool = True
    coloc_threshold_pct: float = 15.0
    costes_scale: int = 255
    costes_fast: bool = True
    costes_fine_scale: int | None = None
    radial_rings: int = 4
    radial_binning: str = "cp"
    radial_lam: float = 1.0
    neighbor_distance: int = 5
    max_radius: int = 64
    convex_dirs: int = 72
    # None = resolved from the input dtype at the measure entry points
    # (integer arrays: True); selects Li's tolerance (0.5 vs 1e-4)
    integer_intensity_grid: bool | None = None
    # the reference's Pallas-dispatch pin; this package dispatches by the
    # tensor's device only, so anything but None is refused
    pallas_dispatch: bool | None = None

    def __post_init__(self):
        for name in ("granularity_subsample", "granularity_bg_sample"):
            v = getattr(self, name)
            if not (0.0 < v <= 1.0) or abs(round(1.0 / v) * v - 1.0) > 1e-9:
                raise ValueError(
                    f"{name}={v} must be a reciprocal integer in (0, 1]"
                    " (CP's granularity subsample is an exact strided gather)"
                )
        if self.radial_binning not in ("cp", "centroid"):
            raise ValueError(f"radial_binning={self.radial_binning!r}: 'cp' or 'centroid'")
        if self.secondary_threshold_scope not in ("global", "adaptive"):
            raise ValueError(
                f"secondary_threshold_scope={self.secondary_threshold_scope!r}:"
                " 'global' or 'adaptive'"
            )
        if self.pallas_dispatch is not None:
            raise ValueError(
                "pallas_dispatch has no meaning here: kernels dispatch by tensor device"
            )


def otsu_threshold(image: torch.Tensor, nbins: int = 256) -> torch.Tensor:
    """Otsu's threshold of each whole image over a ``nbins``-bin histogram
    spanning the image's min to max (CP's default global two-class Otsu):
    image (B, ...) -> (B,) f32, the centre of the bin that maximises the
    between-class variance. The histogram is one per-label count with the
    bin as the label (K1 on CUDA). The bin centres, the cumulative sums and
    the variance's numerator round as the reference's program rounds them
    (fused multiply-adds, XLA's blocked cumsum), so the chosen bin is the
    reference's."""
    b = image.shape[0]
    img = image.reshape(b, -1).float()
    n = img.shape[1]
    lo = img.amin(dim=1, keepdim=True)
    span = torch.clamp(img.amax(dim=1, keepdim=True) - lo, min=1e-12)
    q = torch.clamp((img - lo) / span * nbins, 0, nbins - 1).to(torch.int32)
    zeros = torch.zeros_like(q)
    (hist,) = onehot_counts(q, [(zeros, torch.ones_like(q, dtype=torch.bool), 1)], nbins)
    w = hist[..., 0] / float(n)
    k = (torch.arange(nbins, dtype=torch.float32, device=img.device) + 0.5) / nbins
    centers = sc.fma32(k.expand(b, -1), span, lo)
    omega = _xla_cumsum(w)
    mu = _xla_cumsum(w * centers)
    d = sc.fma32(mu[:, -1:].expand_as(omega), omega, -mu)
    sigma_b = d * d / torch.clamp(omega * (1.0 - omega), min=1e-12)
    return torch.gather(centers, 1, torch.argmax(sigma_b, dim=1, keepdim=True))[:, 0]


def _percentiles(x: torch.Tensor, qs: list[float]) -> list[torch.Tensor]:
    """np.percentile (linear interpolation) of each row of (B, N)."""
    s = torch.sort(x, dim=1).values
    n = s.shape[1]
    out = []
    for q in qs:
        pos = q / 100.0 * (n - 1)
        lo = int(np.floor(pos))
        hi = min(lo + 1, n - 1)
        out.append(s[:, lo] + (s[:, hi] - s[:, lo]) * (pos - lo))
    return out


def _measure_all(image: torch.Tensor, nuclei: torch.Tensor, cfg: FeatureConfig) -> dict:
    """Object derivation + all measurements for a site batch.

    image: (B, H, W, C) f32; nuclei: (B, H, W) int32 compact labels.
    Returns {"objects": {set: {column: (B, max_cells)}}, "image": {column:
    (B,) or (B, k)}}.

    Each family runs inside a profiler range ``measure/<family>``
    (``torch.profiler.record_function``: a no-op unless a profiler
    records), which ``chip_smoke.py --profile`` reads.
    """
    b, h, w, n_ch = image.shape
    # secondary objects grow over the mean of the non-nuclear channels (or
    # the nuclear channel itself when it is the only one)
    body = image[..., 1:].mean(dim=-1) if n_ch > 1 else image[..., 0]
    li_tol = 0.5 if cfg.integer_intensity_grid else 1e-4
    knobs = dict(
        method=cfg.secondary_threshold_method,
        log_transform=cfg.secondary_threshold_log,
        middle_foreground=cfg.secondary_otsu3_middle_foreground,
        correction=cfg.secondary_threshold_correction,
        lower_bound=cfg.secondary_threshold_lower,
        upper_bound=cfg.secondary_threshold_upper,
        li_tolerance=li_tol,
    )
    with record_function("measure/objects"):
        if cfg.secondary_threshold_scope == "adaptive":
            # a per-pixel block-constant map; CP's scalar Threshold_* columns
            # for adaptive scope are the maps' means
            thr, _guide, orig_map = adaptive_threshold(
                body, window_size=cfg.secondary_adaptive_window, **knobs
            )
            orig_thr = orig_map.mean(dim=(1, 2))
            thr_cmp = thr
        else:
            thr, orig_thr = global_threshold(body, **knobs)
            thr_cmp = thr[:, None, None]
        if cfg.secondary_threshold_smoothing > 0:
            sigma = cfg.secondary_threshold_smoothing / 0.6744 / 2.0
            claim_mask = smooth_for_binarize(body, sigma) >= thr_cmp
        else:
            claim_mask = body >= thr_cmp  # CP binarizes with >=
        if cfg.secondary_method == "propagation":
            cells = propagate_labels(
                nuclei, body, thr,
                iterations=cfg.secondary_iterations,
                regularization=cfg.secondary_regularization,
                mask=claim_mask,
            )
        else:
            cells = expand_labels(nuclei, body, thr, iterations=cfg.secondary_iterations or 24)
        cyto = tertiary_objects(cells, nuclei)

    objects = {"Nuclei": nuclei, "Cells": cells, "Cytoplasm": cyto}
    out: dict = {"objects": {}, "image": {}}
    vmax_by_set: dict[str, torch.Tensor] = {}
    for obj_name, labels in objects.items():
        feats: dict[str, torch.Tensor] = {}
        # one EDT per object set, shared by the radii and the CP ring
        # geometry, whose centre search reuses MaximumRadius**2
        cp_rings = cfg.measure_radial and cfg.radial_binning == "cp"
        d2_img = ring_wedge = radius = None
        with record_function("measure/edt_radius"):
            if cfg.measure_radius or cp_rings:
                d2_img = _label_edt_sq(labels, cfg.max_radius)
            if cfg.measure_radius:
                radius = radius_features(labels, cfg.max_cells, cfg.max_radius, d2_img=d2_img)
        if cp_rings:
            rmax = radius["MaximumRadius"] if radius is not None else None
            with record_function("measure/center_race"):
                ring_wedge = cp_ring_wedge(
                    labels, cfg.max_cells, cfg.radial_rings, cfg.max_radius,
                    lam=cfg.radial_lam, d2_img=d2_img,
                    max_d2=None if rmax is None else rmax * rmax,
                )
        del d2_img
        with record_function("measure/fused"):
            fused = fused_object_features(
                image, labels, cfg.max_cells,
                n_rings=cfg.radial_rings,
                with_moments=cfg.measure_moments,
                with_zernike=cfg.measure_zernike,
                with_edge=cfg.measure_edge,
                with_radial=cfg.measure_radial,
                ring_wedge=ring_wedge,
            )
            euler = euler_numbers(labels, cfg.max_cells)
        del ring_wedge
        shape = fused["shape"]
        for k, v in shape.items():
            feats[f"AreaShape_{k}"] = v
        feats["Location_Center_X"] = shape["Center_X"]
        feats["Location_Center_Y"] = shape["Center_Y"]
        feats["AreaShape_EulerNumber"] = torch.where(
            shape["Area"] > 0, euler, torch.zeros_like(euler)
        )
        if cfg.measure_radius:
            for k, v in radius.items():
                feats[f"AreaShape_{k}"] = v
        if cfg.measure_convex:
            with record_function("measure/convex"):
                conv = convex_features(labels, cfg.max_cells, cfg.convex_dirs, area=shape["Area"])
            # per-site count of boundary pixels the hull sweep dropped: admin
            # data for the Image table, not a feature
            out["image"][f"Metadata_BoundaryCompactionOverflow_{obj_name}"] = conv.pop(
                "BoundaryOverflow"
            )
            for k, v in conv.items():
                feats[f"AreaShape_{k}"] = v
        if cfg.measure_moments:
            for k, v in fused["moments"].items():
                feats[f"AreaShape_{k}"] = v
        if cfg.measure_zernike:
            zmag = fused["zernike"]
            for zi, (n, m) in enumerate(ZERNIKE_INDEXES):
                feats[f"AreaShape_Zernike_{n}_{m}"] = zmag[..., zi]
        if cfg.measure_neighbors:
            with record_function("measure/neighbors"):
                neigh = neighbor_features(labels, cfg.max_cells, cfg.neighbor_distance)
            for k, v in neigh.items():
                feats[f"Neighbors_{k}_{cfg.neighbor_distance}"] = v
        cnt_f, vmin_f, vmax_f = fused["stats"]
        if cfg.measure_quantiles or cfg.measure_texture:
            # one per-pixel (vmin, vrange) gather shared by texture and quantiles
            with record_function("measure/pixel_ranges"):
                vrange_f = torch.clamp(vmax_f - vmin_f, min=1e-12)
                g_ranges = mxu_take_t(
                    torch.cat([vmin_f, vrange_f], dim=2), _flat(labels, cfg.max_cells),
                    cfg.max_cells,
                )
            px_ranges = (g_ranges[:, :n_ch], g_ranges[:, n_ch:])
        if cfg.measure_texture:
            with record_function("measure/texture"):
                q_mc = quantize_channels(image, labels, cfg.glcm_levels, px_ranges)
                glcms = object_glcm_multichannel(
                    labels, cfg.max_cells, cfg.glcm_levels, cfg.texture_scale, q_mc
                )
                del q_mc
                for c in range(n_ch):
                    har = haralick_features(glcms[:, c])  # each (B, 4, max_cells)
                    for k in HARALICK_NAMES:
                        for d in range(4):
                            feats[
                                f"Texture_{k}_{cfg.channels[c]}_{cfg.texture_scale}_{d:02d}_{cfg.glcm_levels}"
                            ] = har[k][:, d]
                del glcms
        if cfg.measure_quantiles:
            with record_function("measure/quantiles"):
                quant = quantile_intensity_features_mc(
                    image, labels, cfg.max_cells, stats=(cnt_f, vmin_f, vmax_f),
                    ranges=px_ranges, integer_grid=bool(cfg.integer_intensity_grid),
                )
        if cfg.measure_quantiles or cfg.measure_texture:
            del px_ranges, g_ranges
        for c in range(n_ch):
            ch_name = cfg.channels[c]
            for k, v in fused["intensity"].items():
                if k.startswith(("CenterMassIntensity", "MaxIntensity_")):
                    # CP emits these under Location_ (MeasureObjectIntensity)
                    feats[f"Location_{k}_{ch_name}"] = v[..., c]
                else:
                    feats[f"Intensity_{k}_{ch_name}"] = v[..., c]
            if cfg.measure_quantiles:
                for k, v in quant.items():
                    feats[f"Intensity_{k}_{ch_name}"] = v[..., c]
        if cfg.measure_edge:
            for c in range(n_ch):
                for k, v in fused["edge"].items():
                    feats[f"Intensity_{k}_{cfg.channels[c]}"] = v[..., c]
        if cfg.measure_radial:
            rad = fused["radial"]
            nr = cfg.radial_rings
            for c in range(n_ch):
                ch_name = cfg.channels[c]
                for r in range(nr):
                    for stat in ("FracAtD", "MeanFrac", "RadialCV"):
                        feats[f"RadialDistribution_{stat}_{ch_name}_{r + 1}of{nr}"] = (
                            rad[stat][:, :, r, c]
                        )
        for (a, c), (corr_ab, slope_ab) in fused["corr"].items():
            pair = f"{cfg.channels[a]}_{cfg.channels[c]}"
            feats[f"Correlation_Correlation_{pair}"] = corr_ab
            feats[f"Correlation_Slope_{pair}"] = slope_ab
        for (a, c), (ov, k1, k2) in fused["coloc_quad"].items():
            na, nb = cfg.channels[a], cfg.channels[c]
            feats[f"Correlation_Overlap_{na}_{nb}"] = ov
            feats[f"Correlation_K_{na}_{nb}"] = k1
            feats[f"Correlation_K_{nb}_{na}"] = k2
        vmax_by_set[obj_name] = vmax_f
        out["objects"][obj_name] = feats
        out["image"][f"Count_{obj_name}"] = (shape["Area"] > 0).sum(dim=1).to(torch.int32)

    if cfg.measure_colocalization and n_ch > 1:
        # all three object sets at once (Cells = Nuclei + Cytoplasm)
        with record_function("measure/colocalization"):
            coloc_all = colocalization_features_multiset(
                image, objects, vmax_by_set, cfg.max_cells,
                thr_pct=cfg.coloc_threshold_pct,
                costes_scale=cfg.costes_scale,
                costes_fast=cfg.costes_fast,
                integer_grid=bool(cfg.integer_intensity_grid),
                costes_fine_scale=cfg.costes_fine_scale,
            )
        for obj_name, coloc in coloc_all.items():
            feats = out["objects"][obj_name]
            for key, st in coloc.items():
                if key == "costes_thr":
                    continue
                na, nb = cfg.channels[key[0]], cfg.channels[key[1]]
                feats[f"Correlation_Manders_{na}_{nb}"] = st["M1"]
                feats[f"Correlation_Manders_{nb}_{na}"] = st["M2"]
                feats[f"Correlation_RWC_{na}_{nb}"] = st["RWC1"]
                feats[f"Correlation_RWC_{nb}_{na}"] = st["RWC2"]
                feats[f"Correlation_Costes_{na}_{nb}"] = st["C1"]
                feats[f"Correlation_Costes_{nb}_{na}"] = st["C2"]

    # granularity: all sites x channels reconstruct as one batch of planes
    planes = image.permute(0, 3, 1, 2).reshape(b * n_ch, h, w)
    with record_function("measure/granularity"):
        gran = granularity_spectrum_cp(
            planes, cfg.granularity_length,
            subsample_size=cfg.granularity_subsample,
            image_sample_size=cfg.granularity_bg_sample,
            element_size=cfg.granularity_element_size,
        ).reshape(b, n_ch, -1)
    for c in range(n_ch):
        ch_name = cfg.channels[c]
        out["image"][f"Granularity_{ch_name}"] = gran[:, c]
        # CP MeasureImageIntensity (numpy percentile semantics)
        ch_img = image[..., c].reshape(b, h * w)
        q25, med, q75 = _percentiles(ch_img, [25.0, 50.0, 75.0])
        vmax_img = ch_img.amax(dim=1)
        out["image"][f"Intensity_MeanIntensity_{ch_name}"] = ch_img.mean(dim=1)
        out["image"][f"Intensity_TotalIntensity_{ch_name}"] = ch_img.sum(dim=1)
        out["image"][f"Intensity_MaxIntensity_{ch_name}"] = vmax_img
        out["image"][f"Intensity_MinIntensity_{ch_name}"] = ch_img.amin(dim=1)
        out["image"][f"Intensity_StdIntensity_{ch_name}"] = ch_img.std(dim=1, correction=0)
        out["image"][f"Intensity_MedianIntensity_{ch_name}"] = med
        (mad,) = _percentiles((ch_img - med[:, None]).abs(), [50.0])
        out["image"][f"Intensity_MADIntensity_{ch_name}"] = mad
        out["image"][f"Intensity_LowerQuartileIntensity_{ch_name}"] = q25
        out["image"][f"Intensity_UpperQuartileIntensity_{ch_name}"] = q75
        out["image"][f"Intensity_PercentMaximal_{ch_name}"] = 100.0 * (
            ch_img >= vmax_img[:, None]
        ).float().mean(dim=1)
        out["image"][f"Intensity_TotalArea_{ch_name}"] = torch.full(
            (b,), float(h * w), dtype=torch.float32, device=image.device
        )
    # CP Threshold-module bookkeeping: the corrected/clipped value and the raw
    thr_scalar = thr.mean(dim=(1, 2)) if thr.dim() == 3 else thr
    out["image"]["Threshold_Secondary"] = thr_scalar
    out["image"]["Threshold_FinalThreshold_Cells"] = thr_scalar
    out["image"]["Threshold_OrigThreshold_Cells"] = orig_thr
    return out


def _resolve_integer_grid(cfg: FeatureConfig, images) -> FeatureConfig:
    """``integer_intensity_grid=None`` resolves from the input dtype before
    the f32 cast: integer arrays (raw uint16 TIFFs) -> True."""
    if cfg.integer_intensity_grid is not None:
        return cfg
    dtype = images.dtype
    is_int = (not dtype.is_floating_point) if isinstance(images, torch.Tensor) else bool(
        np.issubdtype(np.asarray(images).dtype, np.integer)
    )
    return dataclasses.replace(cfg, integer_intensity_grid=bool(is_int))


def _as_tensor(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    arr = np.asarray(x)
    if arr.dtype == np.uint16:
        arr = arr.astype(np.int32)  # torch has no uint16 arithmetic
    return torch.as_tensor(arr, device=device).to(dtype)


@dataclass
class MeasureHandle:
    """A dispatched measurement (``measure_site_batch_dispatch``): the result
    leaves packed into one host buffer per dtype, filled by a copy that
    ``ready`` (a CUDA event; None on the CPU) marks complete, and where each
    leaf lies in them. A batch sharded over a mesh has one such handle a
    shard in ``shards``, in site order (its own ``buffers`` are then
    empty)."""

    buffers: dict[torch.dtype, torch.Tensor]
    leaves: list[tuple[tuple[str, ...], torch.dtype, tuple[int, ...], int]]
    ready: torch.cuda.Event | None
    n_sites: int
    shards: list[MeasureHandle] = dataclasses.field(default_factory=list)


def _dispatch_on(images, nuclei_labels, cfg: FeatureConfig, dev: torch.device) -> MeasureHandle:
    """Measure a batch on ``dev`` and start fetching its packed leaves."""
    cuda = dev.type == "cuda"
    with on_device(dev), torch.no_grad():
        img = _as_tensor(images, torch.float32, dev)
        nuc = _as_tensor(nuclei_labels, torch.int32, dev)
        res = _measure_all(img, nuc, cfg)
        flat = [(("objects", o, k), v) for o, feats in res["objects"].items()
                for k, v in feats.items()]
        flat += [(("image", k), v) for k, v in res["image"].items()]
        groups: dict[torch.dtype, list[torch.Tensor]] = {}
        offsets: dict[torch.dtype, int] = {}
        leaves = []
        for key, v in flat:
            off = offsets.get(v.dtype, 0)
            offsets[v.dtype] = off + v.numel()
            leaves.append((key, v.dtype, tuple(v.shape), off))
            groups.setdefault(v.dtype, []).append(v.reshape(-1))
        buffers, ready = {}, None
        for dtype, group in groups.items():
            packed = torch.cat(group)
            if cuda:
                host = torch.empty(packed.shape, dtype=dtype, pin_memory=True)
                host.copy_(packed, non_blocking=True)
                packed = host
            buffers[dtype] = packed
        if cuda:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(dev))
    return MeasureHandle(buffers, leaves, ready, img.shape[0])


def measure_site_batch_dispatch(images, nuclei_labels, cfg: FeatureConfig, device=None,
                                mesh: Mesh | None = None) -> MeasureHandle:
    """Measure a same-shape (B, H, W, C) site batch with its (B, H, W) nuclei
    labels on ``device`` (CUDA unless named) and start fetching the result;
    returns a handle for ``measure_site_batch_finalize``.

    The result leaves are packed on the device into one buffer per dtype (so
    integer columns stay exact), and each buffer starts one ``non_blocking``
    copy into pinned host memory, after which a CUDA event is recorded: the
    host is free as soon as the work is queued. The measurement itself waits
    on the device where a fixpoint loop tests convergence. Finalizing this
    batch after dispatching the next overlaps its copy and table building
    with the next batch's device work. On the CPU the packed buffers are the
    host buffers.

    With a ``mesh`` whose data axis divides B, the batch is split into one
    contiguous shard a data device (``parallel.mesh.shard_batch``) and each
    shard is measured on its device, with packed buffers and pinned copies
    of its own; ``device`` is then not used. Otherwise the batch runs
    unsharded on ``device``, as the reference does."""
    cfg = _resolve_integer_grid(cfg, images)
    if mesh is not None and len(images) % mesh.shape["data"] == 0:
        imgs, nucs = shard_batch(images, mesh), shard_batch(nuclei_labels, mesh)
        parts = [_dispatch_on(i, n, cfg, d)
                 for i, n, d in zip(imgs.shards, nucs.shards, imgs.devices)]
        return MeasureHandle({}, parts[0].leaves, None, len(imgs), parts)
    return _dispatch_on(images, nuclei_labels, cfg, resolve_device(device))


def _host_leaves(handle: MeasureHandle) -> dict[tuple[str, ...], np.ndarray]:
    """Wait for a handle's copy and unpack its leaves."""
    if handle.ready is not None:
        handle.ready.synchronize()
    out = {}
    for key, dtype, shape, off in handle.leaves:
        n = int(np.prod(shape))
        out[key] = handle.buffers[dtype][off : off + n].numpy().reshape(shape)
    return out


def measure_site_batch_finalize(
    handle: MeasureHandle,
    image_numbers: list[int] | None = None,
    metadata: list[dict] | None = None,
) -> list[dict[str, pd.DataFrame]]:
    """Wait for a dispatched measurement's copy, unpack its leaves (a sharded
    batch's shards joined in site order) and build one {'Image', 'Nuclei',
    'Cells', 'Cytoplasm'} table dict per site."""
    if handle.shards:
        parts = [_host_leaves(h) for h in handle.shards]
        leaves = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    else:
        leaves = _host_leaves(handle)
    host: dict = {"objects": {}, "image": {}}
    for key, arr in leaves.items():
        if key[0] == "objects":
            host["objects"].setdefault(key[1], {})[key[2]] = arr
        else:
            host["image"][key[1]] = arr
    b = handle.n_sites
    image_numbers = image_numbers or list(range(1, b + 1))
    metadata = metadata or [{}] * b
    tables = []
    for i in range(b):
        site = {
            "objects": {o: {k: v[i] for k, v in f.items()} for o, f in host["objects"].items()},
            "image": {k: v[i] for k, v in host["image"].items()},
        }
        tables.append(_tables_from_result(site, image_numbers[i], metadata[i]))
    return tables


def measure_site_batch(
    images,
    nuclei_labels,
    cfg: FeatureConfig,
    image_numbers: list[int] | None = None,
    metadata: list[dict] | None = None,
    device=None,
    mesh: Mesh | None = None,
) -> list[dict[str, pd.DataFrame]]:
    """Measure a same-shape (B, H, W, C) site batch with its (B, H, W)
    nuclei labels at once on ``device`` (CUDA unless named), or sharded over
    ``mesh`` when its data axis divides B; returns one {'Image', 'Nuclei',
    'Cells', 'Cytoplasm'} table dict per site
    (``measure_site_batch_dispatch`` then ``measure_site_batch_finalize``)."""
    handle = measure_site_batch_dispatch(images, nuclei_labels, cfg, device=device, mesh=mesh)
    return measure_site_batch_finalize(handle, image_numbers, metadata)


def measure_site(
    image,
    nuclei_labels,
    cfg: FeatureConfig,
    image_number: int = 1,
    metadata: dict | None = None,
    device=None,
) -> dict[str, pd.DataFrame]:
    """Measure one (H, W, C) site; returns its 4 tables."""
    images = image[None] if isinstance(image, torch.Tensor) else np.asarray(image)[None]
    labels = (
        nuclei_labels[None] if isinstance(nuclei_labels, torch.Tensor)
        else np.asarray(nuclei_labels)[None]
    )
    return measure_site_batch(
        images, labels, cfg, [image_number], [metadata or {}], device=device
    )[0]


def _tables_from_result(
    res: dict, image_number: int, metadata: dict | None
) -> dict[str, pd.DataFrame]:
    metadata = metadata or {}
    tables: dict[str, pd.DataFrame] = {}
    # features in sorted name order, as the reference writes them (its
    # result tree comes back through JAX, which sorts dict keys)
    for obj_name, feats in res["objects"].items():
        areas = feats["AreaShape_Area"]
        # slot 0 is never a real object: labels >= max_cells fold into it
        present = np.where(areas > 0)[0]
        present = present[present > 0]
        df = pd.DataFrame({k: feats[k][present] for k in sorted(feats)})
        df.insert(0, "ObjectNumber", present.astype(np.int64))
        df.insert(0, "ImageNumber", image_number)
        df["Number_Object_Number"] = present.astype(np.int64)
        # CP parent/child relations: Cells grow from Nuclei seeds and share
        # label ids; Cytoplasm is derived from Cells
        if obj_name == "Cells":
            df["Parent_Nuclei"] = present.astype(np.int64)
        elif obj_name == "Cytoplasm":
            df["Parent_Cells"] = present.astype(np.int64)
            df["Parent_Nuclei"] = present.astype(np.int64)
        for k, v in metadata.items():
            df[k] = v
        tables[obj_name] = df

    img_row: dict = {"ImageNumber": image_number}
    for k, v in sorted(res["image"].items()):
        if k.startswith("Granularity_"):
            ch = k.split("_", 1)[1]
            for i, g in enumerate(np.asarray(v), start=1):
                img_row[f"Granularity_{i}_{ch}"] = float(g)
        else:
            img_row[k] = np.asarray(v).item()
    for k, v in metadata.items():
        img_row[k] = v
    tables["Image"] = pd.DataFrame([img_row])
    return tables
