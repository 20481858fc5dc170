"""MAD-robustize normalization + platemap annotation (port of
``saguaro_tpu/ops/normalize.py``).

pycytominer-equivalent math (the reference delegates to
``pycytominer.normalize(method="mad_robustize", samples=...)`` at
Pycyto_pertime.py:84-89 and Normalize_CP_ami.py:137-142, and to
``pycytominer.annotate`` at Normalize_CP_ami.py:132):

* fit per-feature median and MAD (scaled by 1.4826) on the *sample subset*
  only (typically the DMSO wells of one timepoint), NaNs ignored;
* transform every row: ``(x - median) / (mad + epsilon)``, epsilon = 1e-18;
* annotate: inner-join the platemap onto profiles on well, platemap
  columns first.

The medians, MADs and the transform run in f32 on the caller's device; the
pandas layer only routes columns. The median of an even count is the mean
of the two middle values (``jnp.nanmedian``, numpy), which
``torch.nanmedian`` is not (it returns the lower one), so ``nanmedian_cols``
computes it from a sort.
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import torch

from saguaro_tpu_torch.device import resolve_device

__all__ = [
    "mad_robustize",
    "normalize_profiles",
    "annotate",
    "split_feature_columns",
    "nanmedian_cols",
]

MAD_SCALE = 1.4826
EPSILON = 1e-18


def split_feature_columns(df: pd.DataFrame) -> tuple[list[str], list[str]]:
    """The suite-wide column convention: anything containing 'Metadata' is
    metadata, everything else is a feature (Pycyto_pertime.py:82,90)."""
    meta = [c for c in df.columns if "Metadata" in c]
    feats = [c for c in df.columns if "Metadata" not in c]
    return meta, feats


def nanmedian_cols(x: torch.Tensor) -> torch.Tensor:
    """Median of each column of (N, F), NaNs ignored: the mean of the two
    middle values of an even count, NaN for a column with none."""
    s = torch.sort(x, dim=0).values  # NaNs sort last
    n = (~torch.isnan(x)).sum(dim=0, keepdim=True)
    lo = s.gather(0, ((n - 1) // 2).clamp(min=0))
    hi = s.gather(0, n // 2)
    return ((lo + hi) * 0.5)[0]


def mad_robustize(values: torch.Tensor, sample_mask: torch.Tensor,
                  epsilon: float = EPSILON) -> torch.Tensor:
    """Robust z-score per column in f32: stats from the masked rows, applied
    to all. values: (N, F); sample_mask: (N,) bool. NaNs inside and outside
    the subset are ignored when fitting (scipy ``nan_policy='omit'``)."""
    values = values.to(torch.float32)
    f32 = dict(dtype=torch.float32, device=values.device)
    masked = torch.where(sample_mask[:, None], values, torch.tensor(float("nan"), **f32))
    med = nanmedian_cols(masked)
    mad = nanmedian_cols((masked - med).abs()) * torch.tensor(MAD_SCALE, **f32)
    return (values - med) / (mad + torch.tensor(epsilon, **f32))


def normalize_profiles(
    profiles: pd.DataFrame,
    features: list[str] | None = None,
    sample_mask: np.ndarray | None = None,
    samples_query: str | None = None,
    device: str | torch.device | None = None,
) -> pd.DataFrame:
    """pycytominer ``normalize(method='mad_robustize')`` equivalent, on
    ``device`` (CUDA unless named).

    ``samples_query`` is a pandas query string (the reference passes e.g.
    ``"Metadata_Compound == 'DMSO' and Metadata_Timepoint == '6'"``);
    alternatively pass a boolean ``sample_mask`` directly. Returns metadata
    columns first, then normalized features.
    """
    dev = resolve_device(device)
    if features is None:
        _, features = split_feature_columns(profiles)
    meta_cols = [c for c in profiles.columns if c not in features]

    if sample_mask is None:
        if samples_query is None or samples_query == "all":
            sample_mask = np.ones(len(profiles), dtype=bool)
        else:
            idx = profiles.query(samples_query).index
            sample_mask = profiles.index.isin(idx)
    sample_mask = np.asarray(sample_mask, dtype=bool)

    vals = profiles[features].to_numpy(dtype=np.float32, na_value=np.nan)
    out = mad_robustize(torch.tensor(vals, device=dev), torch.tensor(sample_mask, device=dev))
    return pd.concat(
        [
            profiles[meta_cols].reset_index(drop=True),
            pd.DataFrame(out.cpu().numpy(), columns=features),
        ],
        axis=1,
    )


def annotate(
    profiles: pd.DataFrame,
    platemap: pd.DataFrame,
    join_on: tuple[str, str] = ("Metadata_Well", "Metadata_Well"),
) -> pd.DataFrame:
    """pycytominer ``annotate`` equivalent: inner-join the platemap onto the
    profiles on well (Normalize_CP_ami.py:132), platemap columns first."""
    left_key, right_key = join_on
    merged = platemap.merge(profiles, left_on=left_key, right_on=right_key, how="inner")
    if left_key != right_key:
        merged = merged.drop(columns=[left_key])
    return merged
