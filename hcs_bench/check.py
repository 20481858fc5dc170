"""The numbers that decide ``correct``: what the timed path produced for the
sampled batch against what the reference works out again from the same
inputs and weights. Each number has its limit in ``limits/<cell>.json``;
``PERF.md`` gives the readings each limit was set from."""

from __future__ import annotations

import re

import numpy as np
import pandas as pd

# What a table value may differ from the reference's by: frozen copy of the
# CPU tests' rule (``tests/torch_data.feature_tolerance``), set there from
# each family's rounding. Integer-valued columns: exactly. Perimeter: 2**-15
# of itself. Spatial, central and normalized moments: 1e-5 of the bound
# area * side**order (normalized: over area**(1 + order / 2)). Hu moments:
# 1e-3 of itself and of the column's largest. Zernike: 1e-5. Mass
# displacement: 1e-5 of the field's side (the CPU tests' 1e-6 is for sums in
# one order: on the card the plain copy's float32 centroids of nuclei 100 px
# across lie 2.4e-3 px from float64's, the program's 5e-4). Everything else:
# 1e-4 of itself plus 1e-4 of the column's largest magnitude in that site's
# table.
_EXACT = (
    r"AreaShape_Area$", r"BoundingBox", r"MaxIntensity_[XY]_", r"Intensity_M(in|ax)Intensity",
    r"EulerNumber", r"ObjectNumber", r"Parent_", r"^Count_", r"ImageNumber", r"TotalArea",
    r"(Median|Maximum)Radius$", r"NumberOfNeighbors", r"BoundaryCompactionOverflow",
)


def feature_tolerance(col: str, ref: np.ndarray, ref_table, h: int, w: int) -> np.ndarray:
    """Allowed |program - reference| for each row of column ``col``."""
    ref = np.asarray(ref, np.float64)
    fin = np.isfinite(ref)
    scale = np.abs(ref[fin]).max() if fin.any() else 0.0
    if any(re.search(k, col) for k in _EXACT):
        return np.zeros_like(ref)
    if col.endswith("_Perimeter"):
        return 2.0**-15 * np.abs(ref)
    m = re.search(r"(Spatial|Central|Normalized)Moment_(\d)_(\d)", col)
    if m:
        order = int(m.group(2)) + int(m.group(3))
        area = ref_table["AreaShape_Area"].to_numpy(np.float64)
        side = np.maximum(
            ref_table["AreaShape_BoundingBoxMaximum_Y"] - ref_table["AreaShape_BoundingBoxMinimum_Y"],
            ref_table["AreaShape_BoundingBoxMaximum_X"] - ref_table["AreaShape_BoundingBoxMinimum_X"],
        ).to_numpy(np.float64) + 1.0
        bound = area * side**order
        if m.group(1) == "Normalized":
            bound = bound / np.maximum(area, 1.0) ** (1.0 + order / 2.0)
        return 1e-5 * bound + 1e-12
    if "HuMoment" in col:
        return 1e-3 * np.abs(ref) + 1e-3 * scale
    if "Zernike" in col:
        return np.full_like(ref, 1e-5)
    if "MassDisplacement" in col:
        return np.full_like(ref, 1e-5 * max(h, w))
    return 1e-4 * np.abs(ref) + 1e-4 * scale


def label_px_off(prog: np.ndarray, ref: np.ndarray) -> float:
    """The batch's share of foreground pixels (either side's, over all its
    sites) outside matched pairs of objects. A pixel is matched where both
    sides label it
    and its program object is the one the reference object overlaps most,
    or its reference object the one the program object overlaps most: an
    object split in two on one side (the seeds' ties break either way under
    rounding) stays matched; a pixel in one side's foreground only, or
    given to another object, does not. A site all wrong reads its share of
    the batch's foreground, about 1 / sites."""
    off = total = 0
    for p, r in zip(prog, ref):
        p, r = p.astype(np.int64).ravel(), r.astype(np.int64).ravel()
        fg = (p > 0) | (r > 0)
        n_fg = int(fg.sum())
        if n_fg == 0:
            continue
        both = (p > 0) & (r > 0)
        p, r = p[both], r[both]
        nr = int(r.max()) + 1 if r.size else 1
        pair, cnt = np.unique(p * nr + r, return_counts=True)
        pp, rr = pair // nr, pair % nr
        best_r: dict = {}
        best_p: dict = {}
        for a, b, c in zip(pp, rr, cnt):
            if c > best_r.get(a, (0, 0))[0]:
                best_r[a] = (c, b)
            if c > best_p.get(b, (0, 0))[0]:
                best_p[b] = (c, a)
        matched = sum(int(c) for a, b, c in zip(pp, rr, cnt) if best_r[a][1] == b or best_p[b][1] == a)
        off += n_fg - matched
        total += n_fg
    return off / total if total else 0.0


def objects_off_by_site(prog: np.ndarray, ref: np.ndarray, iou: float = 0.5) -> np.ndarray:
    """Per site of the reference's, the larger of the shares of the
    reference's objects and of the program's objects that have no partner
    on the other side at an IoU of ``iou`` or more. A site with objects on
    one side only, or missing on the program's side, reads 1; a site empty
    on both sides 0."""
    out = np.ones(len(ref))
    for i, (p, r) in enumerate(zip(prog, ref)):
        p, r = p.astype(np.int64).ravel(), r.astype(np.int64).ravel()
        p_ids, p_area = np.unique(p[p > 0], return_counts=True)
        r_ids, r_area = np.unique(r[r > 0], return_counts=True)
        if p_ids.size == 0 or r_ids.size == 0:
            out[i] = float(p_ids.size != r_ids.size)
            continue
        both = (p > 0) & (r > 0)
        nr = int(r_ids.max()) + 1
        pair, inter = np.unique(p[both] * nr + r[both], return_counts=True)
        pa = p_area[np.searchsorted(p_ids, pair // nr)]
        ra = r_area[np.searchsorted(r_ids, pair % nr)]
        good = inter >= iou * (pa + ra - inter)
        p_found = np.unique(pair[good] // nr).size
        r_found = np.unique(pair[good] % nr).size
        out[i] = max(1.0 - p_found / p_ids.size, 1.0 - r_found / r_ids.size)
    return out


def _column_off(x: np.ndarray, y: np.ndarray, tol: np.ndarray) -> np.ndarray:
    with np.errstate(invalid="ignore"):
        off = ~(np.abs(x - y) <= tol)
    same = (np.isnan(x) & np.isnan(y)) | (np.isinf(x) & (x == y))
    return off & ~same


def table_offs(prog: list, ref: list, h: int, w: int) -> dict[tuple[str, str], float]:
    """Per (table, column) of the reference's, the worst site's share of
    rows off (``feature_tolerance``); a row or column missing on the
    program's side is off, as is every row of a site whose tables are
    missing."""
    out: dict[tuple[str, str], float] = {}
    for i, want in enumerate(ref):
        got = prog[i] if prog is not None and i < len(prog) and prog[i] is not None else {}
        for name, r in want.items():
            g = got.get(name)
            cols = [c for c in r.columns if pd.api.types.is_numeric_dtype(r[c])]
            if g is None:
                share = {c: 1.0 for c in cols}
            else:
                if name == "Image":
                    gi, ri = g.reset_index(drop=True), r.reset_index(drop=True)
                else:
                    gi, ri = g.set_index("ObjectNumber", drop=False), r.set_index("ObjectNumber", drop=False)
                rows = ri.index.union(gi.index)
                gi, ri = gi.reindex(rows), ri.reindex(rows)
                share = {}
                for c in cols:
                    if c not in gi.columns:
                        share[c] = 1.0
                        continue
                    y = ri[c].to_numpy(np.float64)
                    x = gi[c].to_numpy(np.float64)
                    miss = np.isnan(y) != np.isnan(x)
                    off = _column_off(x, y, feature_tolerance(c, y, ri, h, w)) | miss
                    share[c] = float(off.mean()) if len(off) else 0.0
            for c, v in share.items():
                out[(name, c)] = max(out.get((name, c), 0.0), v)
    return out


def embed_gaps(prog: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """1 - cosine of each program embedding against the reference's."""
    p = prog / np.maximum(np.linalg.norm(prog, axis=1, keepdims=True), 1e-30)
    r = ref / np.maximum(np.linalg.norm(ref, axis=1, keepdims=True), 1e-30)
    return 1.0 - (p * r).sum(axis=1)


def judge(numbers: dict[str, float], limits: dict[str, float]) -> tuple[bool, dict]:
    """Each number against its limit: (every number at or under its limit,
    {name: {"value", "limit"}}). A number that is missing or not finite
    fails."""
    out, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name)
        good = v is not None and np.isfinite(v) and v <= limit
        ok &= bool(good)
        out[name] = {"value": None if v is None else float(v), "limit": float(limit)}
    return ok, out
