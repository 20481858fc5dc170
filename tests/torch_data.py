"""Seeded numpy inputs shared by the PyTorch-port parity tests
(``tests/test_torch_*.py``): the same arrays go through the JAX reference
and the port."""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn as tnn
import torch.nn.functional as F


def share_cpu_threads() -> None:
    """Run torch on this test process's share of the cores: under
    pytest-xdist (``PYTEST_XDIST_WORKER_COUNT`` set), ``cpu_count //
    workers`` intra-op threads, at least one. Each worker's default pool is
    as wide as the machine, and several such pools spin against each other
    at every small op's barrier (a rehearsal that takes 12 s alone did not
    finish in 150 s with six at once). Outside xdist nothing changes.
    Every ``tests/test_torch_*.py`` calls it when it is imported."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(workers)))


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


def spiral_path(n: int) -> np.ndarray:
    """(n, n) bool: a one-pixel path winding inward from (0, 0) as a square
    spiral, its loops one pixel apart, so that a value spreading along it
    from its start crosses the plane's middle again on every loop."""
    path = np.zeros((n, n), bool)
    dirs = ((0, 1), (1, 0), (0, -1), (-1, 0))
    y = x = d = 0
    path[0, 0] = True

    def free(dy, dx):
        ny, nx, ay, ax = y + dy, x + dx, y + 2 * dy, x + 2 * dx
        if not (0 <= ny < n and 0 <= nx < n) or path[ny, nx]:
            return False
        return not (0 <= ay < n and 0 <= ax < n and path[ay, ax])

    while True:
        if not free(*dirs[d]):
            d = (d + 1) % 4
            if not free(*dirs[d]):
                return path
        y, x = y + dirs[d][0], x + dirs[d][1]
        path[y, x] = True


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


def feature_tolerance(col: str, ref: np.ndarray, ref_table, h: int, w: int,
                      hu_floor: float = 0.0) -> np.ndarray:
    """Allowed |port - reference| for each row of column ``col``; a HuMoment
    column also allows ``hu_floor`` absolute (for shapes whose Hu moments are
    zero, so that both sides hold rounding noise)."""
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
        return 1e-3 * np.abs(ref) + 1e-3 * scale + hu_floor
    if "Zernike" in col:
        return np.full_like(ref, 1e-5)
    if "MassDisplacement" in col:
        return np.full_like(ref, 1e-6 * max(h, w))
    return 1e-4 * np.abs(ref) + 1e-4 * scale


def assert_tables_close(ref_tables: dict, port_tables: dict, h: int, w: int,
                        hu_floor: float = 0.0) -> None:
    """Same table names, column sets and ObjectNumber rows; every numeric
    column within ``feature_tolerance`` (with ``hu_floor``)."""
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
            tol = feature_tolerance(col, r, ref, h, w, hu_floor)
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


# ----------------------------------------------------------------------------
# A torch mirror of timm's tf_efficientnetv2 with its original block naming,
# driven by an EffNetV2Config of either package (a copy of
# tests/test_weights.py's, which is proven against the flax model there).

def _conv2d_same(x, weight, stride=1, groups=1):
    """TF-SAME conv, asymmetric padding (timm Conv2dSame semantics)."""
    ih, iw = x.shape[-2:]
    kh, kw = weight.shape[-2:]
    pad_h = max((-ih) % stride + kh - stride if ih % stride == 0 else kh - ih % stride, 0)
    pad_h = max((kh - stride) if ih % stride == 0 else (kh - ih % stride), 0)
    pad_w = max((kw - stride) if iw % stride == 0 else (kw - iw % stride), 0)
    x = F.pad(x, (pad_w // 2, pad_w - pad_w // 2, pad_h // 2, pad_h - pad_h // 2))
    return F.conv2d(x, weight, stride=stride, groups=groups)


class _TConvSame(tnn.Conv2d):
    def __init__(self, cin, cout, k, stride=1, groups=1):
        super().__init__(cin, cout, k, stride=stride, groups=groups, bias=False)

    def forward(self, x):
        return _conv2d_same(x, self.weight, self.stride[0], self.groups)


def _tbn(c):
    return tnn.BatchNorm2d(c, eps=1e-3)


class _TConvBnAct(tnn.Module):  # timm ConvBnAct (fused, expand=1, '_skip')
    def __init__(self, cin, cout, k, stride):
        super().__init__()
        self.conv = _TConvSame(cin, cout, k, stride)
        self.bn1 = _tbn(cout)
        self.has_skip = stride == 1 and cin == cout

    def forward(self, x):
        h = F.silu(self.bn1(self.conv(x)))
        return x + h if self.has_skip else h


class _TEdgeResidual(tnn.Module):  # timm EdgeResidual (fused, expand>1)
    def __init__(self, cin, cout, k, stride, expand):
        super().__init__()
        mid = cin * expand
        self.conv_exp = _TConvSame(cin, mid, k, stride)
        self.bn1 = _tbn(mid)
        self.conv_pwl = _TConvSame(mid, cout, 1)
        self.bn2 = _tbn(cout)
        self.has_skip = stride == 1 and cin == cout

    def forward(self, x):
        h = F.silu(self.bn1(self.conv_exp(x)))
        h = self.bn2(self.conv_pwl(h))
        return x + h if self.has_skip else h


class _TSE(tnn.Module):
    def __init__(self, mid, rd):
        super().__init__()
        self.conv_reduce = tnn.Conv2d(mid, rd, 1)
        self.conv_expand = tnn.Conv2d(rd, mid, 1)

    def forward(self, x):
        s = x.mean((2, 3), keepdim=True)
        s = F.silu(self.conv_reduce(s))
        return x * torch.sigmoid(self.conv_expand(s))


class _TInvertedResidual(tnn.Module):  # timm InvertedResidual (MBConv)
    def __init__(self, cin, cout, k, stride, expand, se_ratio):
        super().__init__()
        mid = cin * expand
        self.conv_pw = _TConvSame(cin, mid, 1)
        self.bn1 = _tbn(mid)
        self.conv_dw = _TConvSame(mid, mid, k, stride, groups=mid)
        self.bn2 = _tbn(mid)
        self.se = _TSE(mid, max(1, int(cin * se_ratio)))
        self.conv_pwl = _TConvSame(mid, cout, 1)
        self.bn3 = _tbn(cout)
        self.has_skip = stride == 1 and cin == cout

    def forward(self, x):
        h = F.silu(self.bn1(self.conv_pw(x)))
        h = F.silu(self.bn2(self.conv_dw(h)))
        h = self.se(h)
        h = self.bn3(self.conv_pwl(h))
        return x + h if self.has_skip else h


class TEffNetV2(tnn.Module):
    """timm efficientnetv2 mirror driven by an EffNetV2Config."""

    def __init__(self, config: EffNetV2Config):
        super().__init__()
        self.conv_stem = _TConvSame(3, config.stem_filters, 3, 2)
        self.bn1 = _tbn(config.stem_filters)
        self.blocks = tnn.ModuleList()
        cin = config.stem_filters
        for spec in config.stages:
            stage = tnn.ModuleList()
            for i in range(spec.count):
                stride = spec.stride if i == 0 else 1
                if spec.block == "fused" and spec.expand == 1:
                    stage.append(_TConvBnAct(cin, spec.filters, spec.kernel, stride))
                elif spec.block == "fused":
                    stage.append(
                        _TEdgeResidual(cin, spec.filters, spec.kernel, stride, spec.expand)
                    )
                else:
                    stage.append(
                        _TInvertedResidual(
                            cin, spec.filters, spec.kernel, stride, spec.expand, spec.se_ratio
                        )
                    )
                cin = spec.filters
            self.blocks.append(stage)
        self.conv_head = _TConvSame(cin, config.head_filters, 1)
        self.bn2 = _tbn(config.head_filters)

    def forward(self, x):
        x = F.silu(self.bn1(self.conv_stem(x)))
        for stage in self.blocks:
            for block in stage:
                x = block(x)
        x = F.silu(self.bn2(self.conv_head(x)))
        return x.mean((2, 3))  # pooler_output


def xgb_model_json(n_features: int, n_trees: int = 12, max_depth: int = 5, seed: int = 0,
                   base_score: float = 0.35, objective: str = "binary:logistic") -> str:
    """A hand-written xgboost >= 1.7 JSON model: ``n_trees`` random trees of
    uneven depth (each branch stops early with probability 0.3), thresholds
    around 0 on features drawn from N(0, 1), each split's default (missing
    value) branch random, leaf values in [-1, 1]."""
    import json

    rng = np.random.default_rng(seed)
    trees = []
    for t in range(n_trees):
        left, right, feat, cond, dleft = [], [], [], [], []

        def node(depth):
            i = len(left)
            for a in (left, right, feat, cond, dleft):
                a.append(0)
            if depth == max_depth or (depth > 0 and rng.random() < 0.3):
                left[i] = right[i] = -1
                cond[i] = float(rng.uniform(-1, 1))
                dleft[i] = 1
                return i
            feat[i] = int(rng.integers(0, n_features))
            cond[i] = float(rng.normal(0, 0.5))
            dleft[i] = int(rng.integers(0, 2))
            left[i] = node(depth + 1)
            right[i] = node(depth + 1)
            return i

        node(0)
        trees.append({"id": t, "left_children": left, "right_children": right,
                      "split_indices": feat, "split_conditions": cond, "default_left": dleft,
                      "tree_param": {"num_nodes": str(len(left)), "num_feature": str(n_features)}})
    doc = {
        "learner": {
            "gradient_booster": {"name": "gbtree", "model": {"trees": trees,
                                                             "tree_info": [0] * n_trees}},
            "learner_model_param": {"base_score": f"{base_score:E}", "num_feature": str(n_features)},
            "objective": {"name": objective},
        },
        "version": [1, 7, 6],
    }
    return json.dumps(doc)


def platemap_frame(plate: str, n_wells: int, dmso_every: int = 8) -> "pd.DataFrame":
    """A platemap of wells A01..A24, B01.. (384 wells reach P24): every
    ``dmso_every``-th well DMSO; the other wells hold compounds
    ``CPD000``.. at two concentration levels, two replicate wells each."""
    import pandas as pd

    rows, j = [], 0
    for i in range(n_wells):
        well = f"{chr(65 + i // 24)}{i % 24 + 1:02}"
        if i % dmso_every == 0:
            compound, conc = "DMSO", 1
        else:
            compound, conc = f"CPD{j // 4:03}", 1 + (j // 2) % 2
            j += 1
        rows.append({"Metadata_Compound": compound, "Metadata_ConcLevel": conc,
                     "Metadata_Well": well, "Metadata_Plate": plate})
    return pd.DataFrame(rows)


def write_cp_plate(root: str, plate: str, times: list[str], n_wells: int, columns: dict,
                   seed: int = 0, cells: int = 2, dmso_every: int = 8,
                   workers: int = 1) -> "pd.DataFrame":
    """Profile-stage inputs in the feature-extraction job's layout:
    ``root/<plate>/<time>/{Image,Nuclei,Cells,Cytoplasm}.csv`` for each
    time, one site a well and ``cells`` objects a site, with the job's
    column names ``columns[table]``: ids (``ImageNumber``, ``ObjectNumber``,
    ``Number_Object_Number``, ``Parent_*``) and ``Metadata_*`` filled from
    the well, every other column from the seed (a normal around a
    per-column mean; every fifth compound shifted by 3 sd on a third of the
    columns, so that hit calling finds it). ``root/Plate_<plate>_PlateMap.csv``
    is ``platemap_frame``'s, which it returns. Each time draws from its own
    stream of the seed, so ``workers`` processes (one a time) write the
    same files as one."""
    platemap = platemap_frame(plate, n_wells, dmso_every)
    platemap.to_csv(os.path.join(root, f"Plate_{plate}_PlateMap.csv"), index=False)
    jobs = [(root, plate, time, k, n_wells, columns, seed, cells, dmso_every)
            for k, time in enumerate(times)]
    if workers > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        with ProcessPoolExecutor(min(workers, len(jobs)),
                                 mp_context=multiprocessing.get_context("spawn")) as pool:
            list(pool.map(_write_cp_time, *zip(*jobs)))
    else:
        for job in jobs:
            _write_cp_time(*job)
    return platemap


def _write_cp_time(root: str, plate: str, time: str, k: int, n_wells: int, columns: dict,
                   seed: int, cells: int, dmso_every: int) -> None:
    """``write_cp_plate``'s four tables of ``time``, the ``k``-th time."""
    import pandas as pd

    rng = np.random.default_rng([seed, k])
    platemap = platemap_frame(plate, n_wells, dmso_every)
    shifted = platemap["Metadata_Compound"].map(
        lambda c: c != "DMSO" and int(c[3:]) % 5 == 0).to_numpy()
    out = os.path.join(root, plate, time)
    os.makedirs(out, exist_ok=True)
    for name, cols in columns.items():
        n_obj = 1 if name == "Image" else cells
        n = n_wells * n_obj
        well = np.repeat(np.arange(n_wells), n_obj)
        meta = {"Metadata_Plate": plate, "Metadata_Well": platemap["Metadata_Well"].to_numpy()[well],
                "Metadata_Site": 1, "Metadata_Timepoint": time,
                "Metadata_Compound": platemap["Metadata_Compound"].to_numpy()[well],
                "Metadata_ConcLevel": platemap["Metadata_ConcLevel"].to_numpy()[well]}
        obj = np.tile(np.arange(1, n_obj + 1), n_wells)
        data = {}
        feats = [c for c in cols if not c.startswith("Metadata_")
                 and c not in ("ImageNumber", "ObjectNumber", "Number_Object_Number")
                 and not c.startswith("Parent_")]
        values = rng.normal(rng.normal(0, 5, len(feats)), 1.0, (n, len(feats)))
        values[np.ix_(shifted[well], np.arange(len(feats)) % 3 == 0)] += 3.0
        by_name = dict(zip(feats, values.T))
        for c in cols:
            if c == "ImageNumber":
                data[c] = well + 1
            elif c in ("ObjectNumber", "Number_Object_Number") or c.startswith("Parent_"):
                data[c] = obj
            elif c.startswith("Metadata_"):
                data[c] = meta.get(c, "")
            else:
                data[c] = by_name[c]
        pd.DataFrame(data, columns=list(cols)).to_csv(os.path.join(out, f"{name}.csv"), index=False)


def profile_cli_args(root: str, plate: str, times: list[str], out: str) -> list[tuple[str, list[str]]]:
    """The profile chain over ``write_cp_plate``'s (or a feature-extraction
    job's) layout under ``root``, as (CLI module name, argv) in order:
    normalize_cp, feature_select_cosine on its output, pycyto_pertime,
    concat_cp, and induction_hit on feature_select_cosine's dSig table; every
    output under ``root/<out>/``."""
    return [
        ("normalize_cp", ["--bucket_name", root, "--base_folder", ".", "--plates", plate,
                          "--times", *times, "--output_bucket", root,
                          "--output_prefix", f"{out}/normalized"]),
        ("feature_select_cosine", ["--bucket_name", root, "--base_folder", f"{out}/normalized",
                                   "--plates", plate, "--exp", "Exp", "--output_bucket", root,
                                   "--output_prefix", f"{out}/selected"]),
        ("pycyto_pertime", ["--bucket_name", root, "--base_folder", plate, "--times", *times,
                            "--output_bucket", root, "--output_prefix", f"{out}/pertime"]),
        ("concat_cp", ["--bucket_name", root, "--base_folder", plate, "--output_bucket", root,
                       "--output_prefix", f"{out}/concat", "--times", *times]),
        ("induction_hit", ["--bucket_name", root,
                           "--features_key", f"{out}/selected/Exp_CP_features_selected_allTimes_dSig.csv",
                           "--output_prefix", f"{out}/hits"]),
    ]


def _float_lists(col) -> list | None:
    """A column of printed float lists (``[np.float32(0.5), ...]``) as
    arrays, or None when a cell is not one."""
    out = []
    for cell in col:
        text = str(cell)
        if not (text.startswith("[") and text.endswith("]")):
            return None
        body = text[1:-1].replace("np.float32(", "").replace("np.float64(", "").replace(")", "")
        try:
            out.append(np.array([float(v) for v in body.split(",") if v.strip()]))
        except ValueError:
            return None
    return out


def assert_csv_close(got_path: str, want_path: str, rtol: float = 1e-5) -> tuple[int, int]:
    """Two CSVs hold the same table: the same columns in the same order and
    the same rows; numbers within ``rtol`` (``pandas.testing.assert_frame_equal``),
    printed float lists element by element within ``rtol`` (and 1e-7
    absolute), every other cell equal. Returns the table's shape."""
    import pandas as pd

    got, want = pd.read_csv(got_path), pd.read_csv(want_path)
    assert list(got.columns) == list(want.columns), (
        got_path, sorted(set(got.columns) - set(want.columns)), sorted(set(want.columns) - set(got.columns)))
    assert got.shape == want.shape, (got_path, got.shape, want.shape)
    shape = got.shape
    for c in got.columns:
        g, w = _float_lists(got[c]), _float_lists(want[c])
        if g is not None and w is not None:
            for a, b in zip(g, w):
                np.testing.assert_allclose(a, b, rtol=rtol, atol=1e-7, err_msg=f"{got_path}: {c}")
            got, want = got.drop(columns=c), want.drop(columns=c)
    pd.testing.assert_frame_equal(got, want, rtol=rtol, obj=got_path)
    return shape
