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


def _label_runs(rng, n: int, max_cells: int) -> np.ndarray:
    """n raster labels in runs of 1-90 pixels (a third of them single
    pixels): ids in [1, max_cells) mostly, background 0 and -1, and
    overflow ids >= max_cells."""
    out = np.empty(n, np.int32)
    i = 0
    while i < n:
        length = 1 if rng.random() < 0.33 else int(rng.integers(2, 91))
        u = rng.random()
        if u < 0.2:
            lab = int(rng.choice([0, -1]))
        elif u < 0.27:
            lab = int(rng.choice([max_cells, max_cells + 7, 2**31 - 1]))
        else:
            lab = int(rng.integers(1, max_cells)) if max_cells > 1 else 0
        out[i : i + length] = lab
        i += length
    return out


def adversarial_lane_sites(n_ch: int, max_cells: int, seed: int = 0, h: int = 61, w: int = 211):
    """(images (3, h, w, n_ch) f32 integer grey levels, labels (3, h, w)
    int32) that stress the run-accumulating lane kernels (passes A, C and E).
    Site 0: one object over 44 full rows, 9284 pixels in raster order, wider
    than a strip (64 pixels) and than a block's span (8192), its runs
    crossing row ends; its lower rows sprinkled with single pixels of other
    ids, overflow ids (>= max_cells) and background; then random runs.
    Site 1: all background (0 and -1). Site 2: random runs of 1-90 pixels
    over every id kind. h * w is odd, so the last span is ragged."""
    rng = np.random.default_rng(seed)
    labels = np.zeros((3, h, w), np.int32)
    big = int(rng.integers(1, max_cells)) if max_cells > 1 else max_cells
    labels[0, 2:46] = big
    ys, xs = rng.integers(30, 46, 40), rng.integers(0, w, 40)
    ids = rng.integers(1, max_cells + 8, 40)
    ids[:5] = [max_cells, max_cells + 3, 2**31 - 1, -1, 0]
    labels[0, ys, xs] = ids
    labels[0].reshape(-1)[46 * w :] = _label_runs(rng, (h - 46) * w, max_cells)
    labels[1, h // 2 :] = -1
    labels[2] = _label_runs(rng, h * w, max_cells).reshape(h, w)
    images = rng.integers(0, 4000, (3, h, w, n_ch)).astype(np.float32)
    return images, labels


def _with_sentinels(rng, table: np.ndarray) -> np.ndarray:
    """A few entries of a per-label table set to the values K2's sentinel
    rule reads as 0 (non-finite, +-3.4e38)."""
    flat = table.reshape(-1)
    idx = rng.choice(flat.size, size=max(1, flat.size // 50), replace=False)
    flat[idx] = rng.choice(np.array([np.inf, -np.inf, np.nan, 3.4e38, -3.4e38], np.float32), idx.size)
    return table


def adversarial_lane_args_c(n_ch, max_cells, moments, zernike, edge, zcoef, seed=0):
    """Pass C's arguments (labels, image, border, table, zcoef, max_cells,
    moments, zernike, edge) as numpy arrays on ``adversarial_lane_sites``:
    border flags on a third of the labelled pixels, table rows of centroids
    and bbox origins inside the site, rmax in [1, 80], channel and edge
    means in the image's range, a few sentinel entries."""
    from saguaro_tpu_torch.kernels.segment_cuda import table_cols_c

    images, labels = adversarial_lane_sites(n_ch, max_cells, seed)
    b, h, w = labels.shape
    rng = np.random.default_rng(seed + 1)
    border = ((rng.random(labels.shape) < 0.33) & (labels > 0)).astype(np.uint8)
    cols = [rng.uniform(0, h, (b, max_cells, 1)), rng.uniform(0, w, (b, max_cells, 1))]
    if moments:
        cols += [rng.uniform(0, h, (b, max_cells, 1)), rng.uniform(0, w, (b, max_cells, 1))]
    if zernike:
        cols.append(rng.uniform(1, 80, (b, max_cells, 1)))
    cols.append(rng.uniform(0, 4000, (b, max_cells, n_ch * (2 if edge else 1))))
    table = _with_sentinels(rng, np.concatenate(cols, axis=-1).astype(np.float32))
    assert table.shape[2] == table_cols_c(n_ch, moments, zernike, edge)
    return (labels, images, border, table, np.asarray(zcoef, np.float32), max_cells,
            moments, zernike, edge)


def adversarial_lane_args_a(n_ch, max_cells, with_edge, seed=0):
    """Pass A's arguments (labels, image, pweight, border, max_cells,
    with_edge) as numpy arrays on ``adversarial_lane_sites``: border flags
    on a third of the labelled pixels, perimeter weights of 0, 1/2, 1 and
    sqrt(2)/2 as the perimeter's corner weights give them."""
    images, labels = adversarial_lane_sites(n_ch, max_cells, seed)
    rng = np.random.default_rng(seed + 3)
    border = ((rng.random(labels.shape) < 0.33) & (labels > 0)).astype(np.uint8)
    pweight = rng.choice(np.array([0.0, 0.5, 1.0, np.sqrt(0.5)], np.float32), labels.shape)
    return labels, images, pweight * border, border, max_cells, with_edge


def adversarial_lane_args_e(n_ch, max_cells, seed=0):
    """Pass E's arguments (labels (B, N), image (B, N, C), ranks, tff,
    consts, max_cells) as numpy arrays on ``adversarial_lane_sites``: ranks
    in [0, 3000), Manders thresholds in the image's range with a few
    sentinels, Costes thresholds in the image's range and 1/R = 1/3000."""
    images, labels = adversarial_lane_sites(n_ch, max_cells, seed)
    b = labels.shape[0]
    n = labels[0].size
    rng = np.random.default_rng(seed + 2)
    n_pairs = n_ch * (n_ch - 1) // 2
    ranks = rng.integers(0, 3000, (b, n, n_ch)).astype(np.float32)
    tff = _with_sentinels(rng, rng.uniform(0, 4000, (b, max_cells, n_ch)).astype(np.float32))
    consts = np.concatenate([rng.uniform(0, 4000, (b, 2, n_pairs)),
                             np.full((b, 1, n_pairs), 1.0 / 3000.0)], axis=1).astype(np.float32)
    return labels.reshape(b, n), images.reshape(b, n, n_ch), ranks, tff, consts, max_cells


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


def _edt_rows(seed, shape, lo=0, hi=400):
    rng = np.random.default_rng(seed)
    v2 = rng.integers(lo, hi, shape).astype(np.float32)
    d2 = rng.integers(lo, hi + 600, shape).astype(np.float32)
    return v2, d2


def edt_adversarial_cases() -> dict:
    """{name: (v2, d2, radius)} f32 (B, H, W) inputs that stress K5's walk
    and its early exit: rows of one label (1e18), negative and infinite
    values, NaN in v2 and d2, R = 0, R >= W, W = 1, widths and radii that
    are not multiples of the outputs a thread owns, rows of more than 32
    threads, and a sparse field (one small object in an empty one)."""
    inf_mask = np.random.default_rng(2).random((2, 4, 130)) < 0.3
    nan_v2, nan_d2 = _edt_rows(3, (1, 4, 140))
    nan_v2[0, 1, 70] = np.nan
    nan_d2[0, 2, 5] = np.nan
    sparse = np.zeros((1, 200, 1080), np.int32)
    sparse[0, 90:100, 500:510] = 1
    one = np.full((1, 3, 200), 1e18, np.float32)
    return {
        "one label (1e18)": (one, one.copy(), 64),
        "negative v2": (*_edt_rows(1, (2, 5, 97), lo=-300, hi=300), 20),
        "inf in v2 and d2": (*(np.where(inf_mask, np.inf, a).astype(np.float32)
                               for a in _edt_rows(2, (2, 4, 130))), 33),
        "a NaN": (nan_v2, nan_d2, 17),
        "R = 0": (*_edt_rows(4, (2, 3, 50)), 0),
        "R >= W": (*_edt_rows(5, (1, 3, 37)), 64),
        "R = W - 1": (*_edt_rows(6, (1, 3, 37)), 36),
        "W = 1": (*_edt_rows(7, (2, 5, 1)), 10),
        "W not a multiple of P": (*_edt_rows(8, (2, 3, 1001)), 48),
        "radius not a multiple of P": (*_edt_rows(9, (1, 2, 300)), 13),
        "more than 32 threads a row": (*_edt_rows(10, (1, 2, 555)), 64),
        "sparse field": (sparse, None, 64),
    }


def radial_adversarial_site(case: str, n_ch: int, seed: int = 5):
    """(labels (B, n) int32, codes (B, n) int32, image (B, n, n_ch) f32,
    max_cells, n_codes) that stress K4 radial's runs and warp merge: all
    background, one key over every site, runs of 1-9 pixels over every
    kind of label (negative, 0, in range, >= max_cells) and of code
    (negative, in range, >= n_codes), and the same with an odd n over 3
    sites (every site has a ragged head or tail)."""
    rng = np.random.default_rng(seed)
    b, n, mc, n_codes = 2, 9_000, 64, 32
    if case == "odd n, 3 sites":
        b, n = 3, 4_097
    lab = np.zeros((b, n), np.int32)
    codes = rng.integers(0, n_codes, (b, n)).astype(np.int32)
    if case == "one key":
        lab[:] = 7
        codes[:] = 5
    elif case != "all background":
        lens = rng.integers(1, 10, n)
        lab = np.stack([np.repeat(rng.integers(-2, mc + 5, n), lens)[:n]
                        for _ in range(b)]).astype(np.int32)
        codes = np.stack([np.repeat(rng.integers(-3, n_codes + 3, n), lens[::-1])[:n]
                          for _ in range(b)]).astype(np.int32)
    img = rng.normal(100.0, 50.0, (b, n, n_ch)).astype(np.float32)
    return lab, codes, img, mc, n_codes


RADIAL_CASES = ("all background", "one key", "runs of 1-9", "odd n, 3 sites")


# K6 (the rank pick): every (channels, object sets) the card tests hold
PICK2_CASES = tuple((n_ch, k) for n_ch in (1, 2, 5, 8) for k in (1, 2, 3, 4))


def pick2_case(n_ch: int, k: int, seed: int = 0, n: int | None = None):
    """(hi, lo (B, N, C) int32 byte codes, tables (B, C, 256, 256, K) f32)
    that stress K6's walk: one site where K is odd, else 3; an odd N (by
    default 30,001 + 2C), so that n C is not a multiple of 4 where C is
    odd or 2 mod 4 and the later sites start unaligned; codes in [-3, 259),
    outside [0, 256) on both sides, with runs of one code; tables of
    integers below 2^16, as dense ranks are."""
    rng = np.random.default_rng(seed)
    b = 1 if k % 2 else 3
    n = 30_001 + 2 * n_ch if n is None else n
    hi = rng.integers(-3, 259, (b, n, n_ch)).astype(np.int32)
    lo = rng.integers(-3, 259, (b, n, n_ch)).astype(np.int32)
    hi[:, n // 3 : n // 3 + 40] = 7  # a run of one row
    lo[:, n // 3 : n // 3 + 40] = 9
    tables = rng.integers(0, 65536, (b, n_ch, 256, 256, k)).astype(np.float32)
    return hi, lo, tables
