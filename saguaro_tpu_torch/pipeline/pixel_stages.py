"""Pixel-stage drivers: max projection, re-binning, illumination QC.

Port of ``saguaro_tpu.pipeline.pixel_stages``. Each driver keeps one
reference CLI's contract (inputs, outputs, path rewrites); same-shape
images are batched and the math runs on the device:

* max projection (MaxProjection.py): groups of channels x planes from an
  index CSV; writes TIFFs under an ``ImagesStacked/`` rewrite of the first
  plane's path (:16-22,45-52).
* re-binning (Image_re-binning.py): every image under a prefix resized to
  resolution^2 by Lanczos (K7 on the card), LZW TIFF under an
  ``Image`` -> ``Image_binned`` rewrite (:18-21,53-55).
* illumination QC (Illumination_QC_mult.py): per-site, per-channel
  PowerLogLogSlope + PercentMaximal appended to the LoadData CSV
  (:219-226), with per-channel illum division when shapes match
  (:149-153) and QC_Error_<ch> strings on failures (:141-160).

Reading or decoding one file fails that file alone, as in the reference.
A failure of the batched device work (projection, resize, QC) raises out
of the driver: nothing falls back to another path, and no batch is
dropped as one file's error.
"""

from __future__ import annotations

import logging
import posixpath
from collections import defaultdict

import numpy as np
import pandas as pd
import torch

from saguaro_tpu_torch.device import resolve_device
from saguaro_tpu_torch.io import storage, tiff
from saguaro_tpu_torch.io.loaddata import load_illum_functions
from saguaro_tpu_torch.kernels.illum import illum_correct
from saguaro_tpu_torch.kernels.maxproj import max_project_batch
from saguaro_tpu_torch.kernels.qc import qc_metrics_batch
from saguaro_tpu_torch.kernels.resample import lanczos_resize_batch

logger = logging.getLogger("saguaro_tpu_torch.pixel_stages")

__all__ = [
    "bucket_path",
    "modify_imagepath",
    "VALID_EXTENSIONS",
    "run_max_projection",
    "run_rebin",
    "run_illumination_qc",
]

VALID_EXTENSIONS = (".png", ".jpg", ".jpeg", ".tif", ".tiff")


def bucket_path(bucket: str, key: str = "") -> str:
    """Reference scripts address everything as (bucket, key); map that to a
    storage path: URL buckets and absolute/local dirs join directly,
    bare names become s3:// buckets."""
    if not key:
        return bucket
    if "://" in bucket or bucket.startswith("/") or bucket.startswith("."):
        return storage.join(bucket, key)
    return storage.join(f"s3://{bucket}", key)


def modify_imagepath(filepath: str) -> str:
    """Images/ -> ImagesStacked/ path rewrite (MaxProjection.py:16-22)."""
    parts = filepath.split("/")
    if "Images" not in parts:
        return filepath
    parts[parts.index("Images")] = "ImagesStacked"
    return "/".join(parts)


def _to_device(arrays: list[np.ndarray], dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.stack(arrays)).to(dev)


def run_max_projection(
    bucket_data_set: str,
    data_set: str,
    channels: int,
    planes: int,
    bucket_images: str,
    batch_size: int = 16,
    device: str | torch.device | None = None,
) -> int:
    """Max-project plate z-stacks; returns #projections written. Same-shape
    channel groups are reduced in device batches of ``batch_size``."""
    dev = resolve_device(device)
    df = storage.read_csv_sniffed(bucket_path(bucket_data_set, data_set))
    group_size = channels * planes
    n_written = 0

    # (output_key, [plane paths]) tasks in the reference's grouping: a
    # consecutive chunk of channels*planes rows per field
    tasks: list[tuple[str, list[str]]] = []
    for plate in df["PlateID"].unique():
        sub = df[df["PlateID"] == plate]
        for i in range(0, len(sub), group_size):
            chunk = sub.iloc[i : i + group_size]
            if len(chunk) < group_size:
                logger.warning("Skipping incomplete chunk in plate %s at %d", plate, i)
                continue
            for j in range(channels):
                try:
                    group = [
                        posixpath.join(
                            chunk.iloc[j + (p * channels)].Image_PathName,
                            chunk.iloc[j + (p * channels)].Image_FileName,
                        )
                        for p in range(planes)
                    ]
                    tasks.append((modify_imagepath(group[0]), group))
                except Exception as e:
                    logger.error("Error grouping %d in chunk %d plate %s: %s", j, i, plate, e)

    pending: dict[tuple, list[tuple[str, np.ndarray]]] = defaultdict(list)

    def flush(shape_key):
        nonlocal n_written
        items = pending.pop(shape_key, [])
        if not items:
            return
        projs = max_project_batch(_to_device([s for _, s in items], dev)).cpu().numpy()
        for (out_key, _), proj in zip(items, projs):
            tiff.imwrite(bucket_path(bucket_images, out_key), proj)
            n_written += 1

    for out_key, group in tasks:
        try:
            planes_np = [tiff.imread(bucket_path(bucket_images, p)) for p in group]
            if not all(p.shape == planes_np[0].shape for p in planes_np):
                raise ValueError(f"Image shape mismatch in group: {group}")
            stack = np.stack(planes_np)
        except Exception as e:
            logger.error("Error processing group %s: %s", out_key, e)
            continue
        key = (stack.shape, stack.dtype.str)
        pending[key].append((out_key, stack))
        if len(pending[key]) >= batch_size:
            flush(key)
    for key in list(pending):
        flush(key)
    return n_written


def run_rebin(
    bucket_name: str,
    image_folder: str,
    resolution: int = 1080,
    batch_size: int = 16,
    device: str | torch.device | None = None,
) -> int:
    """Re-bin every image under the prefix to resolution^2 (Lanczos, PIL
    parity); returns #images written."""
    dev = resolve_device(device)
    if not image_folder.endswith("/"):
        image_folder += "/"
    prefix = bucket_path(bucket_name, image_folder)
    n_done = 0
    pending: dict[tuple, list[tuple[str, np.ndarray]]] = defaultdict(list)

    # the reference rewrites only the S3 KEY, never the bucket
    # (Image_re-binning.py:53): the replace runs from the image_folder
    # onward, so a base dir containing 'Image' is never renamed
    folder_marker = image_folder.strip("/").split("/")[-1] or image_folder

    def rewrite(key: str) -> str:
        idx = key.find(folder_marker)
        if idx < 0:
            return key.replace("Image", "Image_binned")
        return key[:idx] + key[idx:].replace("Image", "Image_binned")

    def flush(shape_key):
        nonlocal n_done
        items = pending.pop(shape_key, [])
        if not items:
            return
        batch = _to_device([im for _, im in items], dev)
        out = lanczos_resize_batch(batch, (resolution, resolution)).cpu().numpy()
        for (key, _), img in zip(items, out):
            tiff.imwrite(rewrite(key), img, compression="lzw")
            n_done += 1

    for path in storage.list_prefix(prefix):
        if path.endswith("/") or not path.lower().endswith(VALID_EXTENSIONS):
            continue
        try:
            img = tiff.imread(path)
        except Exception:
            logger.error("Failed to process '%s'", path, exc_info=True)
            continue
        key = (img.shape, img.dtype.str)
        pending[key].append((path, img))
        if len(pending[key]) >= batch_size:
            flush(key)
    for key in list(pending):
        flush(key)
    return n_done


def run_illumination_qc(
    load_data: str,
    data_path: str,
    channels: list[str],
    output: str,
    illum_path: str | None = None,
    batch_size: int = 24,
    device: str | torch.device | None = None,
) -> pd.DataFrame:
    """Append ImageQuality_* columns to the LoadData CSV; returns the df.
    Same-shape images are corrected and measured in device batches of
    ``batch_size``."""
    dev = resolve_device(device)
    df = storage.read_csv_sniffed(load_data)
    drop = [c for c in df.columns if "ImageQuality_" in c or "QC_Error" in c]
    if drop:
        df = df.drop(columns=drop)

    illum = (
        load_illum_functions(illum_path, channels) if illum_path else [None] * len(channels)
    )
    illum_dev = [None if f is None else torch.as_tensor(f).to(dev) for f in illum]

    results: dict[int, dict] = defaultdict(dict)
    # (row index, channel, raw image, illum function or None)
    pending: dict[tuple, list[tuple]] = defaultdict(list)

    def flush(shape_key):
        items = pending.pop(shape_key, [])
        if not items:
            return
        batch = _to_device([im for _, _, im, _ in items], dev).float()
        for k, (_, _, _, f) in enumerate(items):
            if f is not None:
                batch[k] = illum_correct(batch[k], f)
        slopes, pcts = (t.cpu().numpy() for t in qc_metrics_batch(batch))
        for (idx, ch, _, _), s, p in zip(items, slopes, pcts):
            results[idx][f"ImageQuality_PowerLogLogSlope_{ch}"] = float(s)
            results[idx][f"ImageQuality_PercentMaximal_{ch}"] = float(p)

    for idx, row in df.iterrows():
        for i, ch in enumerate(channels):
            path = bucket_path(data_path, str(row[f"FileName_{ch}"]))
            try:
                if not storage.exists(path):
                    results[idx][f"QC_Error_{ch}"] = "File Not Found"
                    continue
                img = tiff.imread(path)
            except Exception as e:
                results[idx][f"QC_Error_{ch}"] = str(e)
                continue
            f = illum_dev[i]
            if f is not None and tuple(f.shape) != img.shape:
                f = None
            key = (img.shape, img.dtype.str)
            pending[key].append((idx, ch, img, f))
            if len(pending[key]) >= batch_size:
                flush(key)
    for key in list(pending):
        flush(key)

    qc_df = pd.DataFrame.from_dict(results, orient="index").sort_index()
    final = pd.concat([df, qc_df], axis=1)
    storage.write_csv(final, output)
    return final
