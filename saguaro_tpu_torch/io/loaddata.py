"""LoadData CSV contract (CellProfiler convention) + plate-layout helpers.

The data contract the whole suite rides on:

* LoadData CSVs carry ``FileName_<channel>`` columns plus
  ``Metadata_Well/Site/Plate/Timepoint`` (reference:
  Cellpose_GPU_s3fs.py:251, 389-390).
* Illumination functions live next to the images as ``<channel>_illum.npy``
  or ``Illum<channel>.npy`` (Cellpose_GPU_s3fs.py:56,
  Illumination_QC_mult.py:186-187).
* QC columns ``ImageQC_*`` mark failing sites; downstream stages keep rows
  whose ImageQC sum is < 1 (Cellpose_GPU_s3fs.py:252-255) or drop failing
  ImageNumbers (Normalize_CP_ami.py:68-80).
* 384-well naming: 24-column rows, ``A01`` style
  (Feature_extraction_opt.py:15-18,40-42).
"""

from __future__ import annotations

import io
import string
from dataclasses import dataclass, field

import numpy as np
import pandas as pd

from saguaro_tpu_torch.io import storage

__all__ = [
    "position_to_well",
    "row_col_to_well",
    "well_to_row_col",
    "channel_filename_columns",
    "site_image_paths",
    "filter_qc_passing",
    "load_illum_functions",
    "load_loaddata",
]


def position_to_well(pos: int, n_cols: int = 24) -> str:
    """1-indexed linear position -> 'A01' (row-major, 24-column default)."""
    row = string.ascii_uppercase[(pos - 1) // n_cols]
    col = (pos - 1) % n_cols + 1
    return f"{row}{col:02}"


def row_col_to_well(row_num: int, col_num: int) -> str:
    """1-indexed (row, col) -> 'A01'."""
    return f"{string.ascii_uppercase[row_num - 1]}{col_num:02}"


def well_to_row_col(well: str) -> tuple[int, int]:
    """'A01' -> 1-indexed (row, col)."""
    return string.ascii_uppercase.index(well[0].upper()) + 1, int(well[1:])


def channel_filename_columns(channels: list[str]) -> list[str]:
    return [f"FileName_{c}" for c in channels]


def load_loaddata(path: str) -> pd.DataFrame:
    return storage.read_csv_sniffed(path)


def filter_qc_passing(load_data: pd.DataFrame, image_qc: pd.DataFrame) -> pd.DataFrame:
    """Keep rows whose ``ImageQC_*`` columns sum to < 1, aligned by row
    order — the reference's pre-segmentation QC filter
    (Cellpose_GPU_s3fs.py:252-255)."""
    qc_cols = image_qc.filter(like="ImageQC_")
    not_failing = qc_cols.sum(axis=1) < 1
    return load_data[np.asarray(not_failing)].copy()


def load_illum_functions(illum_path: str, channels: list[str]) -> list[np.ndarray | None]:
    """Load per-channel illumination functions, trying both reference naming
    conventions: ``<ch>_illum.npy`` then ``Illum<ch>.npy``
    (Illumination_QC_mult.py:186-197)."""
    out: list[np.ndarray | None] = []
    for c in channels:
        arr = None
        for name in (f"{c}_illum.npy", f"Illum{c}.npy"):
            p = storage.join(illum_path, name)
            if storage.exists(p):
                arr = np.load(io.BytesIO(storage.read_bytes(p)))
                break
        out.append(arr)
    return out


def site_image_paths(row: pd.Series, channels: list[str], base_path: str) -> list[str]:
    """Full per-channel image paths for one LoadData row
    (Cellpose_GPU_s3fs.py:259-262)."""
    return [storage.join(base_path, str(row[f"FileName_{c}"])) for c in channels]


@dataclass
class PlateLayout:
    """Static description of a screening plate used for batching."""

    n_rows: int = 16
    n_cols: int = 24
    sites_per_well: int = 1
    channels: list[str] = field(default_factory=list)

    @property
    def n_wells(self) -> int:
        return self.n_rows * self.n_cols

    def wells(self) -> list[str]:
        return [
            row_col_to_well(r + 1, c + 1)
            for r in range(self.n_rows)
            for c in range(self.n_cols)
        ]
