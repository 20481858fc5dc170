"""Seeded numpy inputs shared by the PyTorch-port parity tests
(``tests/test_torch_*.py``): the same arrays go through the JAX reference
and the port."""

from __future__ import annotations

import numpy as np


def blob_sites(
    n_sites: int = 2,
    h: int = 64,
    w: int = 72,
    n_ch: int = 3,
    n_cells: int = 9,
    seed: int = 0,
    overflow_id: int | None = 40,
):
    """(images (B, H, W, C) f32 holding integer grey levels, labels
    (B, H, W) int32). Objects are rotated ellipses of random size, placed
    so that some touch; each site has one object with a hole and, when
    ``overflow_id`` is set, one object whose id is beyond small
    ``max_cells`` bounds (it must fold into the ignored slot 0). Channel 0
    is bright on the objects (nuclei); the other channels are bright on a
    wider ellipse around each (a cell body for Cells to grow into)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    images = np.zeros((n_sites, h, w, n_ch), np.float32)
    labels = np.zeros((n_sites, h, w), np.int32)
    for s in range(n_sites):
        lab = labels[s]
        body = np.zeros((h, w), bool)
        for k in range(1, n_cells + 1):
            cy, cx = rng.uniform(6, h - 6), rng.uniform(6, w - 6)
            a, b = rng.uniform(3.0, 7.5), rng.uniform(2.0, 5.0)
            t = rng.uniform(0, np.pi)
            u = (yy - cy) * np.cos(t) + (xx - cx) * np.sin(t)
            v = -(yy - cy) * np.sin(t) + (xx - cx) * np.cos(t)
            lab[(u / a) ** 2 + (v / b) ** 2 <= 1.0] = k
            body[(u / a) ** 2 + (v / b) ** 2 <= 2.6] = True
        # a hole in object 1 (Euler number 0)
        ys, xs = np.nonzero(lab == 1)
        if len(ys) > 20:
            lab[int(ys.mean()), int(xs.mean())] = 0
        if overflow_id is not None:
            lab[h - 6 : h - 2, 2:6] = overflow_id
        img = rng.integers(80, 120, (h, w, n_ch)).astype(np.float32)
        img[body, 1:] += rng.integers(200, 400, (int(body.sum()), n_ch - 1)).astype(np.float32)
        for k in np.unique(lab[lab > 0]):
            m = lab == k
            img[m, 0] += rng.integers(300, 2500)
            img[m] += rng.integers(0, 150, (int(m.sum()), n_ch)).astype(np.float32)
        images[s] = img
    return images, labels


# Tolerances of the port's features against the reference's, per column.
# The reference sums every payload through a bf16 hi/lo split (~16
# significant bits per value, error <= 2**-16 |v|); the port sums f32.
#  * exact: counts, bounding boxes, pixel locations, min/max intensities,
#    Euler numbers (integers or selected values, no arithmetic), the
#    median and maximum radius (order statistics of integer squared
#    distances), neighbour counts and the hull's dropped boundary pixels;
#  * Perimeter: 2**-15 relative (the reference's split of sqrt(2) weights);
#  * Spatial/Central/Normalized moments: 1e-5 of the row's
#    Area * R**(p+q) (R = the larger bounding-box side), the magnitude of
#    the summed products: first-order central moments vanish by the
#    centroid's definition, so their relative error means nothing;
#  * Hu moments: 1e-3 relative + 1e-3 of the column's largest value
#    (products of normalized moments with cancellation between terms);
#  * Zernike magnitudes (O(1) by normalisation): 1e-5 absolute — m=1
#    moments vanish for a centred shape;
#  * MassDisplacement: 1e-6 * max(H, W) absolute (a difference of two
#    centroids, each with ~1e-7 relative error in pixel coordinates);
#  * everything else: 1e-4 relative + 1e-4 of the column's largest value.
_EXACT = (
    r"AreaShape_Area$", r"BoundingBox", r"MaxIntensity_[XY]_", r"Intensity_M(in|ax)Intensity",
    r"EulerNumber", r"ObjectNumber", r"Parent_", r"^Count_", r"ImageNumber", r"TotalArea",
    r"(Median|Maximum)Radius$", r"NumberOfNeighbors", r"BoundaryCompactionOverflow",
)


def feature_tolerance(col: str, ref: np.ndarray, ref_table, h: int, w: int) -> np.ndarray:
    """Allowed |port - reference| for each row of column ``col``."""
    import re

    ref = np.asarray(ref, np.float64)
    scale = np.abs(ref).max() if ref.size else 0.0
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
        return np.full_like(ref, 1e-6 * max(h, w))
    return 1e-4 * np.abs(ref) + 1e-4 * scale


def assert_tables_close(ref_tables: dict, port_tables: dict, h: int, w: int) -> None:
    """Same table names, column sets and ObjectNumber rows; every numeric
    column within ``feature_tolerance``."""
    import pandas as pd

    assert set(ref_tables) == set(port_tables)
    for name, ref in ref_tables.items():
        got = port_tables[name]
        assert set(ref.columns) == set(got.columns), (name, set(ref.columns) ^ set(got.columns))
        if name != "Image" and len(ref):
            np.testing.assert_array_equal(got["ObjectNumber"].values, ref["ObjectNumber"].values)
        assert len(got) == len(ref)
        for col in ref.columns:
            if not pd.api.types.is_numeric_dtype(ref[col]):
                assert list(got[col]) == list(ref[col]), (name, col)
                continue
            r = ref[col].to_numpy(np.float64)
            g = got[col].to_numpy(np.float64)
            tol = feature_tolerance(col, r, ref, h, w)
            bad = ~(np.abs(g - r) <= tol)
            assert not bad.any(), (name, col, r[bad][:3], g[bad][:3], tol[bad][:3])
