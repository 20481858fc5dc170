"""Feature selection: pycytominer ``feature_select`` equivalent (port of
``saguaro_tpu/ops/select.py``).

The reference runs the operation list
``["variance_threshold", "drop_na_columns", "correlation_threshold",
"drop_outliers"]`` in order (Pycyto_pertime.py:95-106,
Feature_select_cosine_ami.py:65-105) with tunable ``na_cutoff`` (default
0.05 inside pycytominer; the cross-plate CLI default is 0.5) and
``corr_threshold`` (0.9).

Semantics reproduced op by op:

* variance_threshold (freq_cut=0.05, unique_cut=0.01): drop a feature if
  the ratio of its second-most-common to most-common value count is below
  freq_cut (or it has a single unique value), or if its unique-value ratio
  is below unique_cut.
* drop_na_columns: drop features whose NaN fraction exceeds na_cutoff.
* correlation_threshold: over the remaining features, compute the pairwise
  Pearson correlation (pairwise-complete, NaN-aware); for every pair with
  |corr| > threshold, drop the member with the larger total absolute
  correlation (pycytominer's determine_high_cor_pair tie-break — this
  ordering is what makes selected-column sets reproducible).
* drop_outliers (outlier_cutoff=500): drop features with any
  |value| > cutoff.

The O(F^2 N) correlation matrix is the hot spot and runs as masked f64
matmuls on the caller's device (the reference's are f32): the selection's
threshold and ranking are discrete, and in f32 the summation orders of
the card and the CPU flip a pair near the threshold often enough that the
two devices kept different columns. The rank sums are rounded to 1e-9
before the stable sort, so that identical columns tie on every device and
keep their column order. The greedy pair logic is tiny host work.
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import torch

from saguaro_tpu_torch.device import resolve_device
from saguaro_tpu_torch.ops.normalize import split_feature_columns

__all__ = ["feature_select", "nan_aware_correlation", "DEFAULT_OPERATIONS"]

DEFAULT_OPERATIONS = [
    "variance_threshold",
    "drop_na_columns",
    "correlation_threshold",
    "drop_outliers",
]


def _masked_corr(x: torch.Tensor) -> torch.Tensor:
    """Pairwise-complete Pearson correlation of columns of x (N, F).

    For every column pair (i, j) the statistics are computed over rows where
    both are non-NaN, matching pandas ``DataFrame.corr``. All terms are
    (F, F) f64 matmuls of the masked data.
    """
    nan = torch.isnan(x)
    m = (~nan).to(torch.float64)
    x0 = torch.where(nan, 0.0, x).to(torch.float64)
    n = m.T @ m
    sx = x0.T @ m          # sum of x_i over joint support (i rows, j cols)
    sxy = x0.T @ x0
    sxx = (x0 * x0).T @ m
    # covariance and variances over the joint support
    cov = sxy - sx * sx.T / n
    var_i = sxx - sx * sx / n
    var_j = sxx.T - sx.T * sx.T / n
    denom = torch.sqrt(var_i * var_j)
    corr = torch.where(denom > 0, cov / denom, torch.nan)
    return torch.where(n > 1, corr, torch.nan)


def nan_aware_correlation(values: np.ndarray, device: str | torch.device | None = None) -> np.ndarray:
    """Pairwise-complete correlation of the columns of (N, F) ``values`` (f32)
    in f64 on ``device`` (CUDA unless named), returned on the host."""
    dev = resolve_device(device)
    x = torch.tensor(np.asarray(values, dtype=np.float32), device=dev)
    return _masked_corr(x).cpu().numpy()


def _variance_threshold(
    df: pd.DataFrame, features: list[str], freq_cut: float = 0.05, unique_cut: float = 0.01
) -> list[str]:
    excluded: set[str] = set()
    n = len(df)
    for col in features:
        vc = df[col].value_counts()
        if len(vc) <= 1:
            excluded.add(col)
            continue
        if vc.iloc[1] / vc.iloc[0] < freq_cut:
            excluded.add(col)
        if df[col].nunique() / n < unique_cut:
            excluded.add(col)
    return [c for c in features if c not in excluded]


def _drop_na_columns(df: pd.DataFrame, features: list[str], na_cutoff: float) -> list[str]:
    frac = df[features].isna().mean(axis=0)
    return [c for c in features if frac[c] <= na_cutoff]


def _correlation_threshold(
    df: pd.DataFrame, features: list[str], threshold: float, device: torch.device
) -> list[str]:
    if len(features) < 2:
        return features
    vals = df[features].to_numpy(dtype=np.float32, na_value=np.nan)
    corr = np.array(nan_aware_correlation(vals, device))  # writable copy
    np.fill_diagonal(corr, np.nan)
    abs_corr = np.abs(corr)
    # pycytominer: rank features by total |corr| ascending; for each
    # over-threshold pair drop the later-ranked (larger-sum) member.
    # Identical columns (a channel's copy, a measurement in two object
    # tables) have equal sums up to rounding, which differs by device;
    # rounded, they tie exactly and the stable sort keeps column order.
    cor_sum = np.round(np.nansum(abs_corr, axis=1), 9)
    order = np.argsort(cor_sum, kind="stable")
    rank = np.empty(len(features), dtype=int)
    rank[order] = np.arange(len(features))
    iu = np.triu_indices(len(features), k=1)
    over = np.where(np.nan_to_num(abs_corr[iu], nan=0.0) > threshold)[0]
    excluded: set[int] = set()
    for k in over:
        i, j = iu[0][k], iu[1][k]
        excluded.add(i if rank[i] > rank[j] else j)
    return [f for idx, f in enumerate(features) if idx not in excluded]


def _drop_outliers(df: pd.DataFrame, features: list[str], outlier_cutoff: float) -> list[str]:
    max_abs = df[features].abs().max(axis=0)
    return [c for c in features if not (max_abs[c] > outlier_cutoff)]


def feature_select(
    profiles: pd.DataFrame,
    features: list[str] | None = None,
    operation: list[str] = DEFAULT_OPERATIONS,
    na_cutoff: float = 0.05,
    corr_threshold: float = 0.9,
    freq_cut: float = 0.05,
    unique_cut: float = 0.01,
    outlier_cutoff: float = 500.0,
    device: str | torch.device | None = None,
) -> pd.DataFrame:
    """Apply the selection ops in order, the correlations on ``device`` (CUDA
    unless named); returns metadata + kept features."""
    dev = resolve_device(device)
    if features is None:
        _, features = split_feature_columns(profiles)
    meta_cols = [c for c in profiles.columns if c not in features]
    kept = list(features)
    for op in operation:
        if op == "variance_threshold":
            kept = _variance_threshold(profiles, kept, freq_cut, unique_cut)
        elif op == "drop_na_columns":
            kept = _drop_na_columns(profiles, kept, na_cutoff)
        elif op == "correlation_threshold":
            kept = _correlation_threshold(profiles, kept, corr_threshold, dev)
        elif op == "drop_outliers":
            kept = _drop_outliers(profiles, kept, outlier_cutoff)
        else:
            raise ValueError(f"unknown feature_select operation: {op}")
    return profiles[meta_cols + kept].copy()
