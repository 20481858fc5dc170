"""The host-side plans of K3 (``csrc/sums.cu``) and K7 (``csrc/lanczos.cu``)
on the CPU, where the kernels cannot run: K3's lane chunks and its
partition of each site into a ragged head, 16-byte vectors split over
CTAs and a ragged tail; K7's band tables against the dense PIL matrices,
its plan at every ratio chip_smoke and the card tests hold, and the
kernel's walk over tiles, row and column chunks, mirrored here in numpy
index for index, against the plain form."""

import dataclasses

import numpy as np
import pytest
import torch

from saguaro_tpu_torch.kernels import resample as rs
from saguaro_tpu_torch.kernels import resample_cuda as rc
from saguaro_tpu_torch.kernels import segment_cuda as sc

from .torch_data import share_cpu_threads

share_cpu_threads()

# ---------------------------------------------------------------------------
# K3


def _k3_pixels(b, n, plan):
    """The pixels each CTA of site b reads, as sums.cu computes them:
    its first CTA takes the ragged head and tail one pixel at a time;
    every CTA takes its range of 16-byte vectors."""
    g_lo, g_hi = b * n, b * n + n
    a_lo = min((g_lo + 3) & ~3, g_hi)
    a_hi = max(g_hi & ~3, a_lo)
    seen = list(range(g_lo, a_lo)) + list(range(a_hi, g_hi))
    for cta in range(plan.ctas):
        v0 = a_lo // 4 + cta * plan.vecs
        v1 = min(a_hi // 4, v0 + plan.vecs)
        for v in range(v0, v1):
            seen += range(4 * v, 4 * v + 4)
    return seen


@pytest.mark.parametrize("batch,n", [(8, 4_674_244), (8, 1_166_400), (3, 50_001), (2, 40_006),
                                     (1, 70_000), (2, 3), (5, 1), (4, 9_999), (1, 0)])
@pytest.mark.parametrize("resident", [132, 528, 1056])
def test_k3_plan_covers_every_pixel_once(batch, n, resident):
    plan = sc.sums_plan(batch, n, 2, 512, resident)
    assert plan.chunks == ((0, 2),)
    assert 1 <= plan.ctas <= -(-resident // batch)
    if n // 4 >= sc.K3_MIN_VECS * plan.ctas:
        assert plan.vecs >= sc.K3_MIN_VECS
    for b in range(batch) if n < 100_000 else (0, batch - 1):
        seen = _k3_pixels(b, n, plan)
        assert sorted(seen) == list(range(b * n, b * n + n))


def test_k3_plan_at_the_main_path_shapes():
    """About one wave: 8 sites split the resident CTAs, each CTA a
    contiguous range of whole iterations or more."""
    euler = sc.sums_plan(8, 4_674_244, 1, 512, 1056)
    radius = sc.sums_plan(8, 1_166_400, 2, 512, 792)
    assert (euler.ctas, radius.ctas) == (132, 99)
    assert euler.vecs == -(-1_168_561 // 132) and radius.vecs == -(-291_600 // 99)


@pytest.mark.parametrize("k,mc,chunks", [
    (1, 512, ((0, 1),)), (2, 512, ((0, 2),)), (4, 1024, ((0, 4),)), (5, 1024, ((0, 4), (4, 5))),
    (40, 16, tuple((c, c + 4) for c in range(0, 40, 4))),
    (3, 8192, ((0, 3),)), (4, 8192, ((0, 3), (3, 4))), (2, 24_576, ((0, 1), (1, 2))),
])
def test_k3_lane_chunks(k, mc, chunks):
    plan = sc.sums_plan(2, 1000, k, mc, 528)
    assert plan.chunks == chunks
    assert all(4 * mc * (c1 - c0) <= sc.K3_TABLE_BYTES for c0, c1 in chunks)


def test_k3_plan_refuses_what_no_launch_holds():
    with pytest.raises(ValueError, match="labels"):
        sc.sums_plan(1, 10, 1, sc.K3_TABLE_BYTES // 4 + 1, 528)
    with pytest.raises(ValueError, match="sites"):
        sc.sums_plan(65536, 10, 1, 16, 528)
    with pytest.raises(ValueError, match="lanes"):
        sc.sums_plan(1, 10, 0, 16, 528)


def test_k3_wrapper_copies_unaligned_inputs():
    lab = torch.arange(9, dtype=torch.int32)[1:].view(2, 4)
    vals = torch.ones((9, 1))[1:].view(2, 4, 1)
    out = torch.zeros((2, 16, 1))
    (args, (lab_c, vals_c)), = sc.sums_launches(lab, vals, out, sc.sums_plan(2, 4, 1, 16, 528))
    assert lab.data_ptr() % 16 and lab_c.data_ptr() % 16 == 0 and vals_c.data_ptr() % 16 == 0
    assert torch.equal(lab_c, lab) and args[0] == lab_c.data_ptr() and args[3:] == (
        2, 4, 1, 1, 0, 16, 1, 1)


# ---------------------------------------------------------------------------
# K7

# (in_h, in_w, out_h, out_w, dtype): chip_smoke's four shapes, then the card tests'
RATIOS = [
    (2160, 2160, 1080, 1080, np.uint16), (2160, 2160, 1080, 1080, np.float32),
    (540, 720, 1080, 1440, np.uint8), (1001, 1537, 433, 761, np.uint16),
    (540, 600, 270, 300, np.uint16), (40, 56, 97, 71, np.uint8),
    (1000, 900, 30, 25, np.uint16), (333, 250, 160, 121, np.float32),
    (2000, 1800, 40, 60, np.float32), (300, 260, 150, 130, np.uint8),
    (120, 100, 240, 200, np.float32), (37, 23, 19, 50, np.uint16), (64, 64, 32, 32, np.uint16),
    (97, 61, 13, 7, np.uint8),
]


def _plan(in_h, in_w, out_h, out_w, dtype, batch=1, per_sm=1):
    ym, _ = rs.axis_bands(in_h, out_h)
    xm, _ = rs.axis_bands(in_w, out_w)
    return rc.lanczos_plan(ym, xm, batch, np.dtype(dtype).itemsize, 132, lambda r, c: per_sm)


@pytest.mark.parametrize("in_h,in_w,out_h,out_w,dtype", RATIOS)
def test_k7_bands_rebuild_the_dense_matrices(in_h, in_w, out_h, out_w, dtype):
    for n_in, n_out in ((in_h, out_h), (in_w, out_w)):
        meta, w = rs.axis_bands(n_in, n_out)
        dense = np.zeros((4 * len(meta), n_in), np.float32)
        for g, (base, span) in enumerate(meta):
            assert 0 <= base and base + span <= n_in and not w[g, span:].any()
            dense[4 * g : 4 * g + 4, base : base + span] = w[g, :span].T
        assert np.array_equal(dense[:n_out], rs.lanczos_matrices((n_in, 8), (n_out, 4))[0])
        assert not dense[n_out:].any()


@pytest.mark.parametrize("in_h,in_w,out_h,out_w,dtype", RATIOS)
def test_k7_plan_fits_the_card(in_h, in_w, out_h, out_w, dtype):
    plan = _plan(in_h, in_w, out_h, out_w, dtype)
    item = np.dtype(dtype).itemsize
    xm, _ = rs.axis_bands(in_w, out_w)
    assert 1 <= plan.ngx <= 16 and plan.cols % 16 == 0 and 16 <= plan.cols <= rc.LZ_COLS
    assert plan.smem == rc.lanczos_smem(plan.rows, plan.cols, item) <= rc.LZ_SMEM
    assert 1 <= plan.rows <= rc.LZ_BOX_ROWS
    widest = max(rc.staged_cols(lo, hi, item) for lo, hi in rc._windows(xm, plan.ngx))
    if plan.ngx > 1:  # as many column bands as keep the staged window in one buffer
        assert widest <= plan.cols
        assert plan.ngx == 16 or max(rc.staged_cols(lo, hi, item)
                                     for lo, hi in rc._windows(xm, plan.ngx + 1)) > rc.LZ_COLS
    assert plan.tiles == -(-out_h // 64) * -(-(-(-out_w // 4)) // plan.ngx)


def test_k7_plan_at_the_run_point():
    """16 x 2160^2 uint16 -> 1080^2: tiles of 64 x 56 outputs, each
    window staged whole (138 rows x 128 columns), two ring buffers and
    the intermediate in 104 KB, so two CTAs fit a SM."""
    plan = _plan(2160, 2160, 1080, 1080, np.uint16, batch=16, per_sm=2)
    assert (plan.ngx, plan.rows, plan.cols) == (14, 138, 128)
    assert plan.smem == 2 * 138 * 128 * 2 + 128 * 64 * 4 + 16 and plan.smem * 2 <= 227 * 1024
    assert plan.tiles == 16 * 17 * 20 and plan.ctas == 264


def _u32(a: np.ndarray) -> np.ndarray:
    return a.astype(np.float32)


def k7_emulate(img: np.ndarray, out_shape, plan) -> np.ndarray:
    """lanczos.cu's walk in numpy: each tile in turn, its input window from
    the plan, its column chunks and, within them, row chunks staged from the aligned
    column; the vertical pass band by band into the intermediate (stored,
    then added), the horizontal pass after a column chunk's last rows,
    outputs written at the tile's last chunk. f32 arithmetic."""
    b_n, in_h, in_w = img.shape
    out_h, out_w = out_shape
    ym, yw = rs.axis_bands(in_h, out_h)
    xm, xw = rs.axis_bands(in_w, out_w)
    e = 16 // img.dtype.itemsize
    tiles_y, tiles_x = -(-out_h // 64), -(-len(xm) // plan.ngx)
    out = np.full((b_n, out_h, out_w), np.nan, np.float32)

    assert (len(plan.ywin), len(plan.xwin)) == (tiles_y, tiles_x)
    for tile in range(b_n * tiles_y * tiles_x):
        b, r = divmod(tile, tiles_y * tiles_x)
        ty, tx = divmod(r, tiles_x)
        wr0, wr1 = plan.ywin[ty]
        wc0, wc1 = plan.xwin[tx]
        acc = np.zeros((16, plan.ngx, 4, 4), np.float32)
        cx0 = wc0
        while True:
            cs = cx0 & ~(e - 1)
            cx1 = min(wc1, cs + plan.cols)
            mid = np.zeros((plan.cols, 64), np.float32)
            cy0 = wr0
            while True:
                cy1 = min(cy0 + plan.rows, wr1)
                buf = np.zeros((plan.rows, plan.cols), np.float32)
                buf[: cy1 - cy0, : min(cx1, in_w) - cs] = img[b, cy0:cy1, cs:cx1]
                n_cg = -(-(cx1 - cs) // 8)
                assert n_cg <= 16 and cx1 - cs <= plan.cols
                for band in range(16):
                    g = 16 * ty + band
                    v = np.zeros((4, 8 * n_cg), np.float32)
                    if g < len(ym):
                        base, sp = ym[g]
                        for y in range(max(base, cy0), min(base + sp, cy1)):
                            v += _u32(yw[g, y - base])[:, None] * buf[y - cy0, : 8 * n_cg][None]
                    if cy0 == wr0:
                        mid[: 8 * n_cg, 4 * band : 4 * band + 4] = v.T
                    else:
                        mid[: 8 * n_cg, 4 * band : 4 * band + 4] += v.T
                if cy1 >= wr1:
                    break
                cy0 += plan.rows
            for band in range(16):
                for xb in range(plan.ngx):
                    gx = tx * plan.ngx + xb
                    if gx >= len(xm) or 16 * ty + band >= len(ym):
                        continue
                    base, sp = xm[gx]
                    for x in range(max(base, cx0), min(base + sp, cx1)):
                        acc[band, xb] += mid[x - cs, 4 * band : 4 * band + 4][:, None] * xw[gx, x - base][None]
            if cx1 >= wc1:
                break
            cx0 = cx1
        for band in range(16):
            for xb in range(plan.ngx):
                i0, j0 = 64 * ty + 4 * band, 4 * (tx * plan.ngx + xb)
                if j0 < out_w:
                    blk = acc[band, xb][: max(0, min(4, out_h - i0)), : min(4, out_w - j0)]
                    out[b, i0 : i0 + blk.shape[0], j0 : j0 + blk.shape[1]] = blk
    return out


@pytest.mark.parametrize("in_h,in_w,out_h,out_w,dtype,rows,cols", [
    (137, 150, 67, 75, np.uint16, None, None),   # down by ~2, one window a tile
    (137, 150, 67, 75, np.uint16, 40, 32),       # the same in row and column chunks
    (40, 56, 97, 71, np.uint8, None, None),      # upsampling, several tiles
    (300, 290, 9, 11, np.float32, None, None),   # down by ~30: windows wider than a buffer
    (37, 23, 19, 50, np.uint16, 7, 16),          # odd sizes, small chunks
])
def test_k7_walk_matches_the_plain_form(in_h, in_w, out_h, out_w, dtype, rows, cols):
    img = np.random.default_rng(in_h).integers(0, 255, (2, in_h, in_w)).astype(dtype)
    plan = _plan(in_h, in_w, out_h, out_w, dtype, batch=2)
    if rows is not None:
        plan = dataclasses.replace(plan, rows=rows, cols=cols)
    got = k7_emulate(img, (out_h, out_w), plan)
    want = rs.resize_plain(torch.from_numpy(img), (out_h, out_w), dtype=torch.float64).numpy()
    scale = rs.resize_plain(torch.from_numpy(img), (out_h, out_w), magnitude=True,
                            dtype=torch.float64).numpy()
    assert not np.isnan(got).any()
    assert np.all(np.abs(got - want) <= 1e-5 * scale + 1e-6)
