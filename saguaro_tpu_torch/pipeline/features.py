"""Classical feature extraction — CellProfiler-equivalent measurements in
the Image/Nuclei/Cells/Cytoplasm table schema (port of
``saguaro_tpu/pipeline/features.py``).

Per site, nuclei labels are grown into Cells by CP's propagation race over
a globally thresholded cell-body stain, Cytoplasm is Cells minus Nuclei,
and every object set gets the fused shape / moment / Zernike / intensity /
edge / correlation families; the Image table gets the threshold, per-
channel intensity statistics and the granularity spectrum. A site batch is
measured at once: every tensor carries a leading batch dimension.

Ported families: AreaShape (base, moments, Zernike), Location, Intensity
and edge intensity, Correlation (Correlation, Slope, Overlap, K),
Granularity, image intensity and threshold columns. The texture,
quantile, radius, convex-hull, neighbour, colocalization and
radial-distribution families, adaptive threshold scope and smoothing at
binarisation come in later slices: a config that enables one raises
``NotImplementedError`` naming it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import pandas as pd
import torch

from saguaro_tpu_torch.device import resolve_device
from saguaro_tpu_torch.kernels.fused_measure import fused_object_features
from saguaro_tpu_torch.kernels.morphology import (
    expand_labels,
    granularity_spectrum_cp,
    propagate_labels,
    tertiary_objects,
)
from saguaro_tpu_torch.kernels.segment_reduce import euler_numbers
from saguaro_tpu_torch.kernels.thresholding import global_threshold
from saguaro_tpu_torch.kernels.zernike import ZERNIKE_INDEXES

__all__ = [
    "FeatureConfig",
    "measure_site",
    "measure_site_batch",
]


@dataclass(frozen=True)
class FeatureConfig:
    """Field for field the reference's FeatureConfig, with its defaults.
    The defaults enable families this package does not port yet; see the
    module docstring."""

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


def _check_ported(cfg: FeatureConfig, n_ch: int) -> None:
    """Refuse a config that enables a family this package does not port."""
    unported = [
        ("measure_texture", "texture (Haralick)"),
        ("measure_quantiles", "intensity quantiles"),
        ("measure_radius", "AreaShape radii"),
        ("measure_convex", "AreaShape convex hull"),
        ("measure_neighbors", "neighbors"),
        ("measure_radial", "radial distribution"),
    ]
    names = [fam for flag, fam in unported if getattr(cfg, flag)]
    if cfg.measure_colocalization and n_ch > 1:
        names.append("colocalization (Manders/RWC/Costes)")
    if cfg.secondary_threshold_scope == "adaptive":
        names.append("adaptive threshold scope")
    if cfg.secondary_threshold_smoothing > 0:
        names.append("threshold smoothing")
    if names:
        raise NotImplementedError(
            "saguaro_tpu_torch does not measure these yet: " + ", ".join(names)
            + "; turn them off in FeatureConfig"
        )


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
    """
    b, h, w, n_ch = image.shape
    _check_ported(cfg, n_ch)
    # secondary objects grow over the mean of the non-nuclear channels (or
    # the nuclear channel itself when it is the only one)
    body = image[..., 1:].mean(dim=-1) if n_ch > 1 else image[..., 0]
    li_tol = 0.5 if cfg.integer_intensity_grid else 1e-4
    thr, orig_thr = global_threshold(
        body,
        method=cfg.secondary_threshold_method,
        log_transform=cfg.secondary_threshold_log,
        middle_foreground=cfg.secondary_otsu3_middle_foreground,
        correction=cfg.secondary_threshold_correction,
        lower_bound=cfg.secondary_threshold_lower,
        upper_bound=cfg.secondary_threshold_upper,
        li_tolerance=li_tol,
    )
    claim_mask = body >= thr[:, None, None]  # CP binarizes with >=
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
    for obj_name, labels in objects.items():
        feats: dict[str, torch.Tensor] = {}
        fused = fused_object_features(
            image, labels, cfg.max_cells,
            n_rings=cfg.radial_rings,
            with_moments=cfg.measure_moments,
            with_zernike=cfg.measure_zernike,
            with_edge=cfg.measure_edge,
            with_radial=False,
        )
        shape = fused["shape"]
        for k, v in shape.items():
            feats[f"AreaShape_{k}"] = v
        feats["Location_Center_X"] = shape["Center_X"]
        feats["Location_Center_Y"] = shape["Center_Y"]
        euler = euler_numbers(labels, cfg.max_cells)
        feats["AreaShape_EulerNumber"] = torch.where(
            shape["Area"] > 0, euler, torch.zeros_like(euler)
        )
        if cfg.measure_moments:
            for k, v in fused["moments"].items():
                feats[f"AreaShape_{k}"] = v
        if cfg.measure_zernike:
            zmag = fused["zernike"]
            for zi, (n, m) in enumerate(ZERNIKE_INDEXES):
                feats[f"AreaShape_Zernike_{n}_{m}"] = zmag[..., zi]
        for c in range(n_ch):
            ch_name = cfg.channels[c]
            for k, v in fused["intensity"].items():
                if k.startswith(("CenterMassIntensity", "MaxIntensity_")):
                    # CP emits these under Location_ (MeasureObjectIntensity)
                    feats[f"Location_{k}_{ch_name}"] = v[..., c]
                else:
                    feats[f"Intensity_{k}_{ch_name}"] = v[..., c]
        if cfg.measure_edge:
            for c in range(n_ch):
                for k, v in fused["edge"].items():
                    feats[f"Intensity_{k}_{cfg.channels[c]}"] = v[..., c]
        for (a, c), (corr_ab, slope_ab) in fused["corr"].items():
            pair = f"{cfg.channels[a]}_{cfg.channels[c]}"
            feats[f"Correlation_Correlation_{pair}"] = corr_ab
            feats[f"Correlation_Slope_{pair}"] = slope_ab
        for (a, c), (ov, k1, k2) in fused["coloc_quad"].items():
            na, nb = cfg.channels[a], cfg.channels[c]
            feats[f"Correlation_Overlap_{na}_{nb}"] = ov
            feats[f"Correlation_K_{na}_{nb}"] = k1
            feats[f"Correlation_K_{nb}_{na}"] = k2
        out["objects"][obj_name] = feats
        out["image"][f"Count_{obj_name}"] = (shape["Area"] > 0).sum(dim=1).to(torch.int32)

    # granularity: all sites x channels reconstruct as one batch of planes
    planes = image.permute(0, 3, 1, 2).reshape(b * n_ch, h, w)
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
    out["image"]["Threshold_Secondary"] = thr
    out["image"]["Threshold_FinalThreshold_Cells"] = thr
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


def measure_site_batch(
    images,
    nuclei_labels,
    cfg: FeatureConfig,
    image_numbers: list[int] | None = None,
    metadata: list[dict] | None = None,
    device=None,
) -> list[dict[str, pd.DataFrame]]:
    """Measure a same-shape (B, H, W, C) site batch with its (B, H, W)
    nuclei labels at once on ``device`` (CUDA unless named); returns one
    {'Image', 'Nuclei', 'Cells', 'Cytoplasm'} table dict per site."""
    dev = resolve_device(device)
    cfg = _resolve_integer_grid(cfg, images)
    with torch.no_grad():
        img = _as_tensor(images, torch.float32, dev)
        nuc = _as_tensor(nuclei_labels, torch.int32, dev)
        res = _measure_all(img, nuc, cfg)
    b = img.shape[0]
    host = {
        "objects": {
            o: {k: v.cpu().numpy() for k, v in feats.items()}
            for o, feats in res["objects"].items()
        },
        "image": {k: v.cpu().numpy() for k, v in res["image"].items()},
    }
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
    for obj_name, feats in res["objects"].items():
        areas = feats["AreaShape_Area"]
        # slot 0 is never a real object: labels >= max_cells fold into it
        present = np.where(areas > 0)[0]
        present = present[present > 0]
        df = pd.DataFrame({k: v[present] for k, v in feats.items()})
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
    for k, v in res["image"].items():
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
