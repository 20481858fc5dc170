"""CP-table merging + well-level aggregation (a copy of
``saguaro_tpu/ops/aggregate.py``, which is pandas only).

Reproduces the tabular plumbing of the reference's profile stage:

* back-fill ``Metadata_Well/Site`` from Image.csv via ImageNumber
  (Normalize_CP_ami.py:69-77, Pycyto_pertime.py:51-58);
* identify / drop QC-failing ImageNumbers — any true ``ImageQC_*``
  (Normalize_CP_ami.py:68-80);
* per-table column prefixes Image_/DNA_/Cell_/Cyto_
  (Normalize_CP_ami.py:47-52) and the Image_ rename of Pycyto_pertime.py:74;
* missing-site compensation: scale integer (count-like) features by
  max_sites / site_count per well (Normalize_CP_ami.py:95-112);
* well-level groupby aggregation and the 4-table outer merge.
"""

from __future__ import annotations

from functools import reduce

import numpy as np
import pandas as pd

__all__ = [
    "TABLE_PREFIXES",
    "DROP_SUBSTRINGS",
    "backfill_metadata",
    "failing_image_numbers",
    "prefix_features",
    "compensate_missing_sites",
    "aggregate_wells",
    "merge_tables",
]

TABLE_PREFIXES = {
    "Image": "Image_",
    "Nuclei": "DNA_",
    "Cells": "Cell_",
    "Cytoplasm": "Cyto_",
}

DROP_SUBSTRINGS = ["ExecutionTime", "ModuleError", "URL"]


def failing_image_numbers(image_df: pd.DataFrame) -> pd.Series:
    """ImageNumbers whose any ``ImageQC_*`` column is truthy
    (Normalize_CP_ami.py:68)."""
    qc = image_df.filter(like="ImageQC_")
    if qc.shape[1] == 0:
        return pd.Series([], dtype=image_df.get("ImageNumber", pd.Series(dtype=int)).dtype)
    return image_df.loc[qc.any(axis=1), "ImageNumber"]


def backfill_metadata(
    df: pd.DataFrame,
    image_df: pd.DataFrame,
    cols: list[str] = ("Metadata_Well", "Metadata_Site"),
) -> pd.DataFrame:
    """Merge missing metadata columns from Image.csv on ImageNumber."""
    if "Metadata_Well" in df.columns:
        return df
    take = ["ImageNumber"] + [c for c in cols if c in image_df.columns]
    return df.merge(image_df[take], on="ImageNumber", how="left")


def prefix_features(df: pd.DataFrame, prefix: str) -> pd.DataFrame:
    """Prefix non-Metadata columns with the table tag
    (Normalize_CP_ami.py:94,125)."""
    return df.rename(columns=lambda x: x if x.startswith("Metadata_") else prefix + x)


def drop_admin_columns(df: pd.DataFrame, keep_meta: set[str]) -> pd.DataFrame:
    """Drop ImageNumber, unwanted Metadata_, and ExecutionTime/ModuleError/URL
    columns (Normalize_CP_ami.py:87-92,118-123)."""
    drop = [
        col
        for col in df.columns
        if col == "ImageNumber"
        or (col.startswith("Metadata") and col not in keep_meta)
        or any(sub in col for sub in DROP_SUBSTRINGS)
    ]
    return df.drop(columns=drop)


def compensate_missing_sites(df: pd.DataFrame) -> pd.DataFrame:
    """Scale integer (count-like) features by max_sites/site_count per well
    so wells with dropped QC-failing sites stay comparable
    (Normalize_CP_ami.py:95-112). Consumes Metadata_Site."""
    site_counts = df.groupby("Metadata_Well")["Metadata_Site"].nunique()
    max_sites = site_counts.max()
    scaling = (max_sites / site_counts).rename("scaling_factor")
    df = df.merge(scaling, on="Metadata_Well")
    features_to_scale = [
        col
        for col in df.select_dtypes(include="integer").columns
        if not col.startswith("Metadata")
    ]
    df[features_to_scale] = df[features_to_scale].multiply(
        df["scaling_factor"], axis=0
    )
    return df.drop(columns=["scaling_factor", "Metadata_Site"])


def aggregate_wells(
    df: pd.DataFrame, agg_func: str = "mean", by: list[str] = ("Metadata_Well",)
) -> pd.DataFrame:
    # .copy() defragments frames built by repeated column inserts upstream
    # (silences pandas' PerformanceWarning; well-level tables are small)
    return df.copy().groupby(list(by), as_index=False).agg(agg_func)


def merge_tables(tables: dict[str, pd.DataFrame], on="Metadata_Well") -> pd.DataFrame:
    """Outer-merge the per-table well profiles (Normalize_CP_ami.py:129)."""
    on = [on] if isinstance(on, str) else list(on)
    return reduce(
        lambda left, right: pd.merge(left, right, on=on, how="outer"),
        tables.values(),
    )
