"""Pixel-stage helpers. Only ``bucket_path`` is ported so far; the
max-projection, re-binning and illumination-QC stages of
``saguaro_tpu.pipeline.pixel_stages`` come in a later slice."""

from __future__ import annotations

from saguaro_tpu_torch.io import storage

__all__ = ["bucket_path"]


def bucket_path(bucket: str, key: str = "") -> str:
    """Reference scripts address everything as (bucket, key); map that to a
    storage path: URL buckets and absolute/local dirs join directly,
    bare names become s3:// buckets."""
    if not key:
        return bucket
    if "://" in bucket or bucket.startswith("/") or bucket.startswith("."):
        return storage.join(bucket, key)
    return storage.join(f"s3://{bucket}", key)
