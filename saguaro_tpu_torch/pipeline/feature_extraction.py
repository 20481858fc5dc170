"""Classical feature-extraction job (port of
``saguaro_tpu/pipeline/feature_extraction.py``): one controller walks a
(plate, time) job's sites, segments each site batch, measures the
CP-equivalent tables (``pipeline/features``) and writes
Image/Nuclei/Cells/Cytoplasm.csv under the job's output path.
"""

from __future__ import annotations

import logging
from collections import Counter

import numpy as np
import pandas as pd
import torch

from saguaro_tpu_torch.device import resolve_device
from saguaro_tpu_torch.io import storage, tiff
from saguaro_tpu_torch.io.loaddata import load_illum_functions, site_image_paths
from saguaro_tpu_torch.pipeline.features import FeatureConfig, measure_site, measure_site_batch

logger = logging.getLogger("saguaro_tpu_torch.feature_extraction")

__all__ = ["run_feature_extraction_job", "SystemicFailureError"]


class SystemicFailureError(RuntimeError):
    """Raised when degrade-per-site would mask a systemic failure: the SAME
    exception on more than ``max_failure_fraction`` of a job's sites (and
    on at least 2) means a run-wide defect, and the job refuses to write an
    empty-but-plausible plate. One bad site still degrades to an empty
    placeholder."""


_METADATA_COLS = (
    "Metadata_Plate",
    "Metadata_Well",
    "Metadata_Site",
    "Metadata_Timepoint",
    "Metadata_Compound",
    "Metadata_ConcLevel",
)


def run_feature_extraction_job(
    load_data: pd.DataFrame,
    image_path: str,
    output_path: str,
    channels: list[str],
    segmenter,
    feature_cfg: FeatureConfig | None = None,
    illum_path: str | None = None,
    site_batch: int = 8,
    max_failure_fraction: float = 0.5,
    device: str | torch.device | None = None,
) -> dict[str, str]:
    """One (plate, time) job: segment + measure every site, write 4 tables.

    ``segmenter`` supplies nuclei masks: a plain callable
    ``segmenter(image) -> labels`` or an engine-like object exposing
    ``.segment(image)`` and optionally ``.segment_batch(images) -> list``
    (SegmentEmbedEngine); batches of ``site_batch`` same-shape sites are
    then segmented and measured at once on ``device`` (CUDA unless named).
    A failing batch degrades to per-site work, a failing site to an
    empty-table placeholder; the same failure on most sites raises
    ``SystemicFailureError``.
    """
    dev = resolve_device(device)
    cfg = feature_cfg or FeatureConfig(channels=tuple(channels))
    illum = load_illum_functions(illum_path, channels) if illum_path else None
    seg_one = getattr(segmenter, "segment", segmenter)
    seg_batch = getattr(segmenter, "segment_batch", None)

    site_failures: dict[int, str] = {}

    def _record_failure(image_number: int, e: Exception):
        site_failures[image_number] = f"{type(e).__name__}: {e}"[:500]

    def empty_tables(image_number: int, metadata: dict) -> dict[str, pd.DataFrame]:
        return {
            name: pd.DataFrame([{"ImageNumber": image_number, **metadata}])
            if name == "Image"
            else pd.DataFrame()
            for name in ("Image", "Nuclei", "Cells", "Cytoplasm")
        }

    # host I/O: load channels + illum-correct, bucket same-shape sites
    per_site_tables: dict[int, dict[str, pd.DataFrame]] = {}
    buckets: dict[tuple, list] = {}
    metas: dict[int, dict] = {}
    for i, row in load_data.reset_index(drop=True).iterrows():
        image_number = i + 1
        metadata = {c: row[c] for c in _METADATA_COLS if c in row.index}
        metas[image_number] = metadata
        try:
            chans = []
            for k, p in enumerate(site_image_paths(row, channels, image_path)):
                img = tiff.imread(p).astype(np.float32)
                if illum and illum[k] is not None and img.shape == illum[k].shape:
                    img = img / illum[k]
                chans.append(img)
            image = np.stack(chans, axis=-1)
            buckets.setdefault(image.shape, []).append((image_number, image))
        except Exception as e:
            logger.error("site %d failed: %s", image_number, e)
            _record_failure(image_number, e)
            per_site_tables[image_number] = empty_tables(image_number, metadata)

    def measure_one(image_number, image, labels):
        try:
            per_site_tables[image_number] = measure_site(
                image, labels, cfg, image_number, metas[image_number], device=dev
            )
        except Exception as e:
            logger.error("site %d measurement failed: %s", image_number, e)
            _record_failure(image_number, e)
            per_site_tables[image_number] = empty_tables(image_number, metas[image_number])

    for items in buckets.values():
        for s in range(0, len(items), site_batch):
            chunk = items[s : s + site_batch]
            labels_list: list = [None] * len(chunk)
            if seg_batch is not None:
                try:
                    labels_list = list(seg_batch(np.stack([im for _, im in chunk])))
                except Exception as e:
                    logger.error("batched segmentation failed (%s); per-site fallback", e)
                    labels_list = [None] * len(chunk)
            for j, (n, im) in enumerate(chunk):
                if labels_list[j] is None:
                    try:
                        labels_list[j] = seg_one(im)
                    except Exception as e:
                        logger.error("site %d segmentation failed: %s", n, e)
                        _record_failure(n, e)
            ok = [(n, im, lb) for (n, im), lb in zip(chunk, labels_list) if lb is not None]
            for (n, im), lb in zip(chunk, labels_list):
                if lb is None:
                    per_site_tables[n] = empty_tables(n, metas[n])
            if not ok:
                continue
            nums = [n for n, _, _ in ok]
            try:
                labels = torch.stack(
                    [torch.as_tensor(np.asarray(lb) if not isinstance(lb, torch.Tensor) else lb)
                     .to(device=dev, dtype=torch.int32) for _, _, lb in ok]
                )
                tables = measure_site_batch(
                    np.stack([im for _, im, _ in ok]), labels, cfg,
                    image_numbers=nums, metadata=[metas[n] for n in nums], device=dev,
                )
            except Exception as e:
                logger.error("batch %s failed (%s); per-site fallback", nums, e)
                for n, im, lb in ok:
                    measure_one(n, im, lb)
                continue
            for n, t in zip(nums, tables):
                per_site_tables[n] = t

    if site_failures:
        n_sites = max(len(per_site_tables), 1)
        common_err, n_common = Counter(site_failures.values()).most_common(1)[0]
        if n_common >= max(2, int(np.ceil(max_failure_fraction * n_sites))):
            raise SystemicFailureError(
                f"{n_common}/{n_sites} sites failed with the same error — "
                f"systemic, refusing to write an empty plate: {common_err}"
            )

    all_tables: dict[str, list[pd.DataFrame]] = {}
    for image_number in sorted(per_site_tables):
        for name, df in per_site_tables[image_number].items():
            all_tables.setdefault(name, []).append(df)

    written = {}
    for name, dfs in all_tables.items():
        out = storage.join(output_path, f"{name}.csv")
        storage.write_csv(pd.concat(dfs, ignore_index=True), out)
        written[name] = out
    return written
