"""Induction-score hit calling (port of ``saguaro_tpu/ops/induction.py``).

Reference math (Inuction_Score_hit.py:39-126):

* induction score per well = fraction of (non-metadata) features above the
  induction threshold (default 0.95);
* per-(plate, timepoint) bioactivity threshold = the DMSO wells' induction
  quantile (default 0.95, pandas linear interpolation);
* mean induction per (plate, timepoint, compound, concentration);
* Bioactive = mean induction >= the (plate, timepoint) threshold
  (missing threshold -> +inf, never bioactive).
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import torch

from saguaro_tpu_torch.device import resolve_device

__all__ = ["induction_scores", "dmso_thresholds", "hit_calling"]


def _induction(values: torch.Tensor, threshold: float) -> torch.Tensor:
    over = (values > threshold).to(torch.float32)
    # the reference's division by the constant feature count compiles to a
    # product with its f32 reciprocal; the port takes the same product
    n = torch.tensor(float(values.shape[1]), dtype=torch.float32, device=values.device)
    return torch.sum(over, dim=1) * torch.reciprocal(n)


def induction_scores(
    profiles: pd.DataFrame,
    induction_threshold: float = 0.95,
    feature_cols: list[str] | None = None,
    device: str | torch.device | None = None,
) -> pd.Series:
    """Per-row induction score (Inuction_Score_hit.py:50-52), on ``device``
    (CUDA unless named).

    NOTE the reference uses ``col.startswith("Metadata_")`` here (not the
    contains-Metadata rule used elsewhere).
    """
    if feature_cols is None:
        feature_cols = [c for c in profiles.columns if not c.startswith("Metadata_")]
    vals = profiles[feature_cols].to_numpy(dtype=np.float32, na_value=np.nan)
    dev = resolve_device(device)
    scores = _induction(torch.tensor(vals, device=dev), induction_threshold).cpu().numpy()
    return pd.Series(scores, index=profiles.index, name="induction")


def dmso_thresholds(
    sig_ind: pd.DataFrame,
    quantile: float = 0.95,
    dmso: str = "DMSO",
) -> dict:
    """Per-(plate, timepoint) DMSO induction quantile
    (Inuction_Score_hit.py:59-67)."""
    dmso_rows = sig_ind[sig_ind["Metadata_Compound"] == dmso]
    return (
        dmso_rows.groupby(["Metadata_Plate", "Metadata_Timepoint"])["induction"]
        .quantile(quantile)
        .to_dict()
    )


def hit_calling(
    profiles: pd.DataFrame,
    bioactive_threshold_quantile: float = 0.95,
    induction_threshold: float = 0.95,
    dmso: str = "DMSO",
    device: str | torch.device | None = None,
) -> tuple[pd.DataFrame, dict, pd.DataFrame]:
    """Full hit-calling pass, the induction scores on ``device`` (CUDA unless
    named).

    Returns (ind_mean with Bioactive flag, thresholds dict, sig_ind table).
    """
    sig = profiles.copy()
    sig["induction"] = induction_scores(sig, induction_threshold, device=device)
    sig_ind = sig[[
        "Metadata_Plate", "Metadata_Well", "Metadata_Timepoint",
        "Metadata_Compound", "Metadata_ConcLevel", "induction",
    ]]
    thresholds = dmso_thresholds(sig_ind, bioactive_threshold_quantile, dmso)

    ind_mean = (
        sig_ind[sig_ind["Metadata_Compound"] != dmso]
        .groupby(["Metadata_Plate", "Metadata_Timepoint", "Metadata_Compound", "Metadata_ConcLevel"])
        .agg(induction_mean=("induction", "mean"))
        .reset_index()
    )
    ind_mean["Bioactive"] = ind_mean.apply(
        lambda row: int(
            row["induction_mean"]
            >= thresholds.get((row["Metadata_Plate"], row["Metadata_Timepoint"]), np.inf)
        ),
        axis=1,
    )
    return ind_mean, thresholds, sig_ind
