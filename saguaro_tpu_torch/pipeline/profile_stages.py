"""Profile-stage drivers: the tabular post-processing CLIs (port of
``saguaro_tpu/pipeline/profile_stages.py``).

Each function mirrors one reference script end to end — same inputs, same
S3/file layout, same output names — with the numeric cores (robustize,
correlations, cosine blocks, squash) on ``device`` (CUDA unless named)
through ``saguaro_tpu_torch.ops``.

* run_normalize_cp        <- Normalize_CP_ami.py:29-151 (C18)
* run_pycyto_pertime      <- Pycyto_pertime.py:29-172 (C17)
* run_feature_select_cosine <- Feature_select_cosine_ami.py:39-164 (C19)
* run_concat_cp           <- ConcatCP_exp.py:13-97 (C21)
"""

from __future__ import annotations

import logging
from functools import reduce

import numpy as np
import pandas as pd
import torch

from saguaro_tpu_torch.device import resolve_device
from saguaro_tpu_torch.io import storage
from saguaro_tpu_torch.ops import (
    annotate,
    double_sigmoid,
    feature_select,
    group_cosine_similarity,
    normalize_profiles,
)
from saguaro_tpu_torch.ops.aggregate import (
    TABLE_PREFIXES,
    aggregate_wells,
    backfill_metadata,
    compensate_missing_sites,
    drop_admin_columns,
    failing_image_numbers,
    merge_tables,
    prefix_features,
)
from saguaro_tpu_torch.ops.normalize import split_feature_columns
from saguaro_tpu_torch.pipeline.pixel_stages import bucket_path

logger = logging.getLogger("saguaro_tpu_torch.profile_stages")

__all__ = [
    "run_normalize_cp",
    "run_pycyto_pertime",
    "run_feature_select_cosine",
    "run_concat_cp",
]

_META_MERGE_COLS = [
    "ImageNumber",
    "Metadata_Plate",
    "Metadata_Site",
    "Metadata_Well",
    "Metadata_Timepoint",
    "Metadata_Compound",
    "Metadata_ConcLevel",
]


def _apply_dsig_abs(df: pd.DataFrame, device: torch.device) -> pd.DataFrame:
    _, feats = split_feature_columns(df)
    df = df.copy()
    vals = torch.tensor(df[feats].to_numpy(dtype=np.float32, na_value=np.nan), device=device)
    df[feats] = double_sigmoid(vals).abs().cpu().numpy()
    return df


def run_normalize_cp(
    bucket_name: str,
    base_folder: str,
    plates: list[str],
    times: list[str],
    output_bucket: str,
    output_prefix: str,
    dmso: str = "DMSO",
    well_agg_func: str = "mean",
    no_time_subfolder: bool = False,
    qc_drop: bool = False,
    device: str | torch.device | None = None,
) -> list[str]:
    """Per plate x timepoint: 4-table merge -> well aggregate -> annotate ->
    mad_robustize vs DMSO -> Normalized_features_{time}.csv. Returns the
    written paths."""
    dev = resolve_device(device)
    written = []
    for plate in plates:
        logger.info("Processing plate %s", plate)
        platemap = storage.read_csv_sniffed(
            bucket_path(bucket_name, f"{base_folder}/Plate_{plate.lstrip('binned/')}_PlateMap.csv")
        )
        platemap = platemap[
            ["Metadata_Compound", "Metadata_ConcLevel", "Metadata_Well", "Metadata_Plate"]
        ].copy()
        platemap["Metadata_Compound"] = platemap["Metadata_Compound"].map(
            lambda x: str(x).upper()
        )
        for time in times:
            tables: dict[str, pd.DataFrame] = {}
            for name in TABLE_PREFIXES:
                sub = f"{base_folder}/{plate}/{name}.csv" if no_time_subfolder else f"{base_folder}/{plate}/{time}/{name}.csv"
                tables[name] = storage.read_csv_sniffed(bucket_path(bucket_name, sub))

            image_df = tables["Image"]
            failing = failing_image_numbers(image_df)
            for name, df in tables.items():
                df = backfill_metadata(df, image_df)
                if qc_drop:
                    df = df[~df["ImageNumber"].isin(failing)]
                tables[name] = df

            for name, prefix in TABLE_PREFIXES.items():
                df = tables[name]
                keep = {"Metadata_Well", "Metadata_Site"} if qc_drop else {"Metadata_Well"}
                df = drop_admin_columns(df, keep)
                df = prefix_features(df, prefix)
                if qc_drop:
                    df = compensate_missing_sites(df)
                tables[name] = aggregate_wells(df, well_agg_func)

            merged = merge_tables(tables)
            merged = annotate(merged, platemap)
            merged["Metadata_Timepoint"] = time
            norm = normalize_profiles(
                merged,
                samples_query=f"Metadata_Compound == '{dmso}' and Metadata_Timepoint == '{time}'",
                device=dev,
            )
            out = bucket_path(output_bucket, f"{output_prefix}/{plate}/Normalized_features_{time}.csv")
            storage.write_csv(norm, out)
            logger.info("Saved %s", out)
            written.append(out)
    return written


def run_pycyto_pertime(
    bucket_name: str,
    base_folder: str,
    times: list[str],
    output_bucket: str,
    output_prefix: str,
    device: str | torch.device | None = None,
) -> dict[str, list[str]]:
    """Per timepoint: merge -> well mean -> mad_robustize vs DMSO ->
    double-sigmoid+abs -> feature_select -> cosine blocks. Writes
    CP_features_selected.csv + the two cosine CSVs per time."""
    dev = resolve_device(device)
    written: dict[str, list[str]] = {"selected": [], "avg_cosine": [], "cosine": []}
    for time in times:
        logger.info("timepoint %s", time)
        tables = {
            name: storage.read_csv_sniffed(bucket_path(bucket_name, f"{base_folder}/{time}/{name}.csv"))
            for name in ("Image", "Nuclei", "Cells", "Cytoplasm")
        }
        image = tables["Image"]
        for name in ("Nuclei", "Cells", "Cytoplasm"):
            df = tables[name]
            if "Metadata_Site" not in df.columns:
                cols = [c for c in _META_MERGE_COLS if c in image.columns]
                df = df.merge(image[cols], on="ImageNumber", how="left")
            tables[name] = df

        group_cols = ["Metadata_Plate", "Metadata_Well", "Metadata_Timepoint", "Metadata_Compound"]
        for name in ("Nuclei", "Cells", "Cytoplasm"):
            df = tables[name].drop(
                columns=[c for c in ("ImageNumber", "Metadata_Site", "Metadata_ConcLevel") if c in tables[name].columns]
            )
            tables[name] = df.groupby(group_cols, as_index=False).mean()
        image = image.drop(columns=["ImageNumber"])
        image = image.drop(
            columns=[
                c for c in image.columns
                if image[c].dtype == "object" and not c.startswith("Metadata")
            ]
        )
        image = image.groupby(group_cols, as_index=False).mean()
        image = image.rename(
            columns=lambda x: ("Image_" + x)
            if x not in (
                "Metadata_Plate", "Metadata_Timepoint", "Metadata_Well",
                "Metadata_Site", "Metadata_Compound", "Metadata_ConcLevel",
            )
            else x
        )
        merged = reduce(
            lambda l, r: pd.merge(l, r, on=group_cols, how="outer"),
            [tables["Cells"], tables["Nuclei"], image, tables["Cytoplasm"]],
        )
        merged["Metadata_Timepoint"] = time
        merged["Metadata_Plate"] = base_folder.split("/")[-1]

        norm = normalize_profiles(
            merged,
            samples_query=f"Metadata_Compound == 'DMSO' and Metadata_Timepoint == '{time}'",
            device=dev,
        )
        norm = _apply_dsig_abs(norm, dev)
        selected = feature_select(norm, device=dev)  # pycytominer defaults (na 0.05, corr 0.9)
        sel_path = bucket_path(output_bucket, f"{output_prefix}/{time}/CP_features_selected.csv")
        storage.write_csv(selected, sel_path)
        written["selected"].append(sel_path)

        cos_input = selected.drop(
            columns=[c for c in ("Metadata_Plate", "Metadata_Well", "Metadata_Site") if c in selected.columns]
        )
        avg, raw = group_cosine_similarity(cos_input, device=dev)
        avg = avg.rename(
            columns={
                "Metadata_Compound": "Metadata_compound_code",
                "Metadata_ConcLevel": "Metadata_compound_concentration",
            }
        )
        avg_path = bucket_path(
            output_bucket, f"{output_prefix}/{time}/CPfeatures_average_cosine_similarity.csv"
        )
        storage.write_csv(avg, avg_path)
        written["avg_cosine"].append(avg_path)

        raw_df = pd.DataFrame(
            [
                {
                    "Metadata_Compound": r["Metadata_Compound"],
                    "Metadata_Timepoint": r["Metadata_Timepoint"],
                    "Metadata_Condition": r["Metadata_ConcLevel"],
                    "cosine_similarities": list(np.asarray(r["cosine_similarities"])),
                    "Replicates": r["Replicates"],
                }
                for r in raw
            ]
        )
        raw_path = bucket_path(
            output_bucket, f"{output_prefix}/{time}/CPfeatures_cosine_similarities.csv"
        )
        storage.write_csv(raw_df, raw_path)
        written["cosine"].append(raw_path)
    return written


def run_feature_select_cosine(
    bucket_name: str,
    base_folder: str,
    plates: list[str],
    exp: str,
    output_bucket: str,
    output_prefix: str,
    na_cutoff: float = 0.5,
    corr_threshold: float = 0.9,
    per_time: bool = False,
    device: str | torch.device | None = None,
) -> dict[str, str | list[str]]:
    """Cross-plate feature selection + double-sigmoid + cosine similarity."""
    dev = resolve_device(device)
    dfs = []
    for plate in plates:
        prefix = bucket_path(bucket_name, f"{base_folder}/{plate}/")
        matching = [p for p in storage.list_prefix(prefix) if "Normalized_features" in p]
        logger.info("plate %s: %d normalized files", plate, len(matching))
        for p in matching:
            dfs.append(storage.read_csv_sniffed(p))
    normalized = pd.concat(dfs, ignore_index=True)
    written: dict = {}

    if per_time:
        per_time_frames = []
        written["per_time"] = []
        for tp in normalized["Metadata_Timepoint"].unique():
            df_time = normalized[normalized["Metadata_Timepoint"] == tp]
            sel = feature_select(df_time, na_cutoff=na_cutoff, corr_threshold=corr_threshold,
                                 device=dev)
            sel = sel.copy()
            sel["Metadata_Timepoint"] = tp
            per_time_frames.append(sel)
            out = bucket_path(output_bucket, f"{output_prefix}/{exp}CP_features_selected_{tp}_dSig.csv")
            storage.write_csv(sel, out)
            written["per_time"].append(out)
        selected = pd.concat(per_time_frames, ignore_index=True).fillna(0)
    else:
        selected = feature_select(normalized, na_cutoff=na_cutoff, corr_threshold=corr_threshold,
                                  device=dev)

    raw_path = bucket_path(output_bucket, f"{output_prefix}/{exp}_CP_features_selected_allTimes_raw.csv")
    storage.write_csv(selected, raw_path)
    written["raw"] = raw_path

    dsig = _apply_dsig_abs(selected, dev)
    dsig_path = bucket_path(output_bucket, f"{output_prefix}/{exp}_CP_features_selected_allTimes_dSig.csv")
    storage.write_csv(dsig, dsig_path)
    written["dsig"] = dsig_path

    cos_input = dsig.drop(
        columns=[c for c in ("Metadata_Plate", "Metadata_Well") if c in dsig.columns]
    )
    avg, _ = group_cosine_similarity(cos_input, device=dev)
    avg_path = bucket_path(output_bucket, f"{output_prefix}/{exp}_Average_cosine_similarity.csv")
    storage.write_csv(avg, avg_path)
    written["avg_cosine"] = avg_path
    return written


def run_concat_cp(
    bucket_name: str,
    base_folder: str,
    output_bucket: str,
    output_prefix: str,
    times: list[str] | None = None,
    device: str | torch.device | None = None,
) -> dict[str, str]:
    """Legacy concatenator: per-type CSVs across timepoints with image
    metadata merged in (ConcatCP_exp.py). Host only: ``device`` is resolved
    as every entry point's is, and nothing runs on it."""
    resolve_device(device)
    times = times or ["12h", "18h", "24h_2", "48h_2", "6h", "72h_2"]
    datasets = ["nuclei", "cytoplasm", "image", "cells"]
    frames: dict[str, list[pd.DataFrame]] = {d: [] for d in datasets}

    for time in times:
        image_metadata = pd.DataFrame()
        try:
            image_metadata = storage.read_csv_sniffed(
                bucket_path(bucket_name, f"{base_folder}/{time}/Image.csv")
            )
            frames["image"].append(image_metadata)
        except Exception as e:
            logger.error("Error processing image file for %s: %s", time, e)
        for ft in datasets:
            if ft == "image":
                continue
            try:
                df = storage.read_csv_sniffed(
                    bucket_path(bucket_name, f"{base_folder}/{time}/{ft.capitalize()}.csv")
                )
                df["Metadata_Timepoint"] = time
                if "ImageNumber" in df.columns and len(image_metadata):
                    cols = [c for c in ("ImageNumber", "Metadata_Plate", "Metadata_Site", "Metadata_Well") if c in image_metadata.columns]
                    df = df.merge(image_metadata[cols], on="ImageNumber", how="left")
                frames[ft].append(df)
            except Exception as e:
                logger.error("Error processing %s/%s: %s", time, ft, e)

    written = {}
    for ft, dfs in frames.items():
        if not dfs:
            continue
        out = bucket_path(output_bucket, f"{output_prefix}/concatenated_{ft}.csv")
        storage.write_csv(pd.concat(dfs, ignore_index=True), out)
        written[ft] = out
    return written
