"""Replicate cosine-similarity blocks (port of ``saguaro_tpu/ops/cosine.py``).

Reference behavior (Pycyto_pertime.py:115-172,
Feature_select_cosine_ami.py:125-164): for every unique
(compound, timepoint, concentration) group, compute the pairwise cosine
similarity of the member feature rows (NaNs filled with 0), take the upper
triangle excluding the diagonal, and average it.

The whole plate's groups run as one padded batch on the caller's device:
groups are padded to the max replicate count, rows are L2-normalized, and
one batched f32 matmul (TF32 off) produces every group's similarity
matrix.
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import torch

from saguaro_tpu_torch.device import full_f32, resolve_device

__all__ = ["pairwise_cosine", "group_cosine_similarity"]


def _unit_rows(x: torch.Tensor) -> torch.Tensor:
    norms = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    return x / torch.where(norms > 0, norms, 1.0)


def pairwise_cosine(x: torch.Tensor) -> torch.Tensor:
    """sklearn ``cosine_similarity`` parity over rows of (N, F), in f32."""
    xn = _unit_rows(x.to(torch.float32))
    with full_f32():
        return xn @ xn.T


def group_cosine_similarity(
    profiles: pd.DataFrame,
    group_cols: list[str] = ("Metadata_Compound", "Metadata_Timepoint", "Metadata_ConcLevel"),
    feature_cols: list[str] | None = None,
    device: str | torch.device | None = None,
) -> tuple[pd.DataFrame, list[dict]]:
    """Per-group mean pairwise cosine similarity, the products on ``device``
    (CUDA unless named).

    Returns (averaged_df, raw_records):
      averaged_df columns = group_cols + ['average_cosine_similarity'];
      raw_records carry the upper-triangle values per group (the
      *_cosine_similarities.csv payload, Pycyto_pertime.py:150-156).
    """
    dev = resolve_device(device)
    group_cols = list(group_cols)
    if feature_cols is None:
        feature_cols = [c for c in profiles.columns if "Metadata" not in c]

    x = profiles[feature_cols].to_numpy(dtype=np.float32, na_value=np.nan)
    x = np.nan_to_num(x, nan=0.0)

    keys = profiles[group_cols].drop_duplicates().values.tolist()
    key_to_gid = {tuple(k): i for i, k in enumerate(keys)}
    gids = np.array(
        [key_to_gid[tuple(r)] for r in profiles[group_cols].values.tolist()],
        dtype=np.int32,
    )
    n_groups = len(keys)
    counts = np.bincount(gids, minlength=n_groups)
    max_group = int(counts.max()) if n_groups else 0

    # Pad each group's member rows to max_group and run one batched matmul.
    order = np.argsort(gids, kind="stable")
    sorted_rows = x[order]
    offsets = np.zeros(n_groups + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    gathered = np.zeros((n_groups, max_group, x.shape[1]), dtype=np.float32)
    valid = np.zeros((n_groups, max_group), dtype=bool)
    for g in range(n_groups):
        c = counts[g]
        gathered[g, :c] = sorted_rows[offsets[g]:offsets[g] + c]
        valid[g, :c] = True

    sims = _group_sims(torch.tensor(gathered, device=dev)).cpu().numpy()

    averaged, raw = [], []
    iu = np.triu_indices(max_group, k=1)
    for g, key in enumerate(keys):
        c = counts[g]
        mask = (iu[0] < c) & (iu[1] < c)
        tri = sims[g][iu][mask]
        avg = float(np.mean(tri)) if tri.size else float("nan")
        rec = dict(zip(group_cols, key))
        # member row labels, as the reference stores group.index per
        # record (Pycyto_pertime.py:150-156, 'Replicates' column)
        members = list(profiles.index[order[offsets[g]:offsets[g] + c]])
        averaged.append({**rec, "average_cosine_similarity": avg})
        raw.append({**rec, "cosine_similarities": tri, "Replicates": members})
    return pd.DataFrame(averaged), raw


def _group_sims(gathered: torch.Tensor) -> torch.Tensor:
    """(G, M, F) padded groups -> (G, M, M) cosine matrices (one batch)."""
    xn = _unit_rows(gathered)
    with full_f32():
        return torch.bmm(xn, xn.transpose(1, 2))
