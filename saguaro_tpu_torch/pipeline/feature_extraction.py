"""Classical feature-extraction driver (port of
``saguaro_tpu/pipeline/feature_extraction.py``), the CellProfiler-fleet
replacement: ``run_batch_processing`` walks the (plate x time) job grid,
and each job (``run_feature_extraction_job``) segments its site batches,
measures the CP-equivalent tables (``pipeline/features``) and writes
Image/Nuclei/Cells/Cytoplasm.csv under ``<base>/<plate>/<time>/``, the
layout the profile stages read.
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
from saguaro_tpu_torch.parallel.distributed import partition_jobs
from saguaro_tpu_torch.parallel.mesh import Mesh, default_mesh_for
from saguaro_tpu_torch.pipeline.features import (
    FeatureConfig,
    measure_site,
    measure_site_batch_dispatch,
    measure_site_batch_finalize,
)
from saguaro_tpu_torch.pipeline.manifest import Manifest
from saguaro_tpu_torch.pipeline.pixel_stages import bucket_path
from saguaro_tpu_torch.utils import timing
from saguaro_tpu_torch.utils.timing import StageTimer

logger = logging.getLogger("saguaro_tpu_torch.feature_extraction")

__all__ = ["run_feature_extraction_job", "run_batch_processing", "SystemicFailureError"]


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
    timer: StageTimer | None = None,
    mesh: Mesh | None = None,
) -> dict[str, str]:
    """One (plate, time) job: segment + measure every site, write 4 tables.

    ``segmenter`` supplies nuclei masks: a plain callable
    ``segmenter(image) -> labels`` or an engine-like object exposing
    ``.segment(image)`` and optionally ``.segment_batch(images) -> list``
    (SegmentEmbedEngine); batches of ``site_batch`` same-shape sites are
    then segmented and measured at once on ``device`` (CUDA unless named).
    A batch is finalized (its result fetched and its tables built) after
    the next batch is dispatched, so that work overlaps the next batch's
    device work. A failing batch degrades to per-site work, a failing site
    to an empty-table placeholder; the same failure on most sites raises
    ``SystemicFailureError``. ``timer`` accumulates the host seconds of the
    stages ``read``, ``segment``, ``dispatch``, ``finalize`` and ``write``;
    without one they go to the active recorder (``utils.timing.stage``).
    With a ``mesh`` a batch whose size its data axis divides is measured
    sharded over it (``measure_site_batch_dispatch``).
    """
    dev = resolve_device(device)
    stage = timer.stage if timer is not None else timing.stage
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
            with stage("read"):
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

    pending = None

    def _finalize_pending(p):
        if p is None:
            return
        handle, p_nums, p_ok = p
        try:
            with stage("finalize"):
                tables = measure_site_batch_finalize(
                    handle, image_numbers=p_nums, metadata=[metas[n] for n in p_nums]
                )
            for n, t in zip(p_nums, tables):
                per_site_tables[n] = t
        except Exception as e:
            logger.error("batch %s failed (%s); per-site fallback", p_nums, e)
            for n, im, lb in p_ok:
                measure_one(n, im, lb)

    for items in buckets.values():
        for s in range(0, len(items), site_batch):
            chunk = items[s : s + site_batch]
            labels_list: list = [None] * len(chunk)
            with stage("segment"):
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
                with stage("dispatch"):
                    labels = torch.stack(
                        [torch.as_tensor(np.asarray(lb) if not isinstance(lb, torch.Tensor) else lb)
                         .to(device=dev, dtype=torch.int32) for _, _, lb in ok]
                    )
                    handle = measure_site_batch_dispatch(
                        np.stack([im for _, im, _ in ok]), labels, cfg, device=dev, mesh=mesh
                    )
            except Exception as e:
                logger.error("batch %s dispatch failed (%s); per-site fallback", nums, e)
                for n, im, lb in ok:
                    measure_one(n, im, lb)
                continue
            # the previous batch's fetch and tables overlap this batch's
            # device work
            _finalize_pending(pending)
            pending = (handle, nums, ok)

    _finalize_pending(pending)

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
    with stage("write"):
        for name, dfs in all_tables.items():
            out = storage.join(output_path, f"{name}.csv")
            storage.write_csv(pd.concat(dfs, ignore_index=True), out)
            written[name] = out
    return written


def run_batch_processing(
    bucket_name: str,
    base_output_path: str,
    plates: list[str],
    times: list[str],
    channels: list[str],
    image_path_for_job,
    load_data_key_for_job,
    segmenter,
    feature_cfg: FeatureConfig | None = None,
    resume: bool = True,
    site_batch: int = 8,
    device: str | torch.device | None = None,
    timer: StageTimer | None = None,
    mesh: Mesh | None | str = None,
) -> dict[tuple[str, str], dict[str, str]]:
    """Walk the (plate x time) job grid (the fleet orchestrator's role,
    Feature_extraction_opt.py:73-145): outputs land at
    ``<base>/<plate>/<time>/``, each job on ``device`` (CUDA unless named).

    With several processes (``parallel.distributed``), each takes its stride
    of the grid (``partition_jobs``); the manifest at
    ``<base>/manifest.jsonl`` makes re-runs skip completed jobs.
    ``image_path_for_job(plate, time)`` and ``load_data_key_for_job(plate,
    time)`` encode the project's path conventions (the reference hardcodes
    them at :153-156). ``mesh``: None (the default) measures each batch on
    ``device``; a Mesh shards each measurement batch over it; ``"auto"``
    shards over every visible CUDA device when there are several and
    ``device`` names no CPU and no one card (``parallel.mesh.
    default_mesh_for``). Sharded measurement is not the default: no run on
    several cards has shown it faster yet.
    """
    if mesh == "auto":
        mesh = default_mesh_for(device)
        if mesh is not None:
            logger.info("run_batch_processing: %d-device measurement mesh", mesh.size)
    dev = resolve_device(device)
    results = {}
    jobs = partition_jobs([(p, t) for p in plates for t in times])
    manifest = Manifest(bucket_path(base_output_path, "manifest.jsonl")) if resume else None
    logger.info("Generated %d jobs (this process)", len(jobs))
    for plate, time in jobs:
        unit = f"{plate}/{time}"
        if manifest is not None and manifest.is_done(unit):
            logger.info("Job %s already complete; skipping (resume)", unit)
            continue
        logger.info("Job %s", unit)
        load_data = storage.read_csv_sniffed(
            bucket_path(bucket_name, load_data_key_for_job(plate, time))
        )
        results[(plate, time)] = run_feature_extraction_job(
            load_data,
            bucket_path(bucket_name, image_path_for_job(plate, time)),
            bucket_path(base_output_path, unit),
            channels,
            segmenter,
            feature_cfg,
            site_batch=site_batch,
            device=dev,
            timer=timer,
            mesh=mesh,
        )
        if manifest is not None:
            manifest.mark_done(unit, n_sites=len(load_data))
    return results
