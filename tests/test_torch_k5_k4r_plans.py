"""The host-side plans and the walks of K5 (``csrc/edt_sweep.cu``) and K4
radial (``csrc/radial_sums.cu``) on the CPU, where the kernels cannot
run. K5: its row geometry, and its walk (one warp a row, register windows
of candidates, block minima, the warp's exact early exit), mirrored here
in numpy step for step and held bit for bit against ``edt_sweep_plain``.
K4 radial: its plan's partition of each site into a ragged head, 16-byte
vectors split over CTAs and a ragged tail, and its walk (runs of equal
keys in registers, the hand-over of a run to the previous lane, the
segmented warp merge), mirrored in numpy and held against
``radial_sums_plain``: counts exactly, sums in f64 to 1e-12 relative."""

import numpy as np
import pytest
import torch

from saguaro_tpu_torch.kernels import segment_cuda as sc
from saguaro_tpu_torch.kernels.shape_extra import _edt_sweep_inputs

from .torch_data import (
    RADIAL_CASES,
    blob_sites,
    edt_adversarial_cases,
    radial_adversarial_site,
    share_cpu_threads,
)

share_cpu_threads()

F32 = np.float32

# ---------------------------------------------------------------------------
# K5


def _k5_geometry(w, radius, p, s):
    """(reff, kp, wp, span) of edt_sweep.cu built with K5_P = p, K5_S = s."""
    reff = min(radius, w - 1)
    kp = -(-reff // s) * s
    wp = -(-w // p) * p
    span = -(-(wp + 2 * kp) // 32) * 32
    if (p, s) == (sc.K5_P, sc.K5_S):
        g = sc.edt_geometry(w, radius)
        assert (g.reff, g.kp, g.wp, g.span) == (reff, kp, wp, span)
    return reff, kp, wp, span


def k5_emulate(v2: np.ndarray, d2: np.ndarray, radius: int, p: int = sc.K5_P,
               s: int = sc.K5_S, blk: int = sc.K5_BLOCK):
    """K5's walk over (B, H, W) f32 rows, as edt_sweep.cu runs it: each
    row staged with a halo of kp either side, +inf outside the row, and its
    ``blk``-value block minima; each group of ``p`` consecutive outputs (a
    lane's, taken from the row's queue) with left and right windows of
    p + s candidates; before each block of s steps the group stops once
    fl(smin + dx^2) >= best for every pixel it owns, smin the minimum of
    the blocks its pixels can reach. Returns the output, the blocks each
    group ran (rows, groups a row) and each group's first x."""
    b, h, w = v2.shape
    reff, kp, segw, span = _k5_geometry(w, radius, p, s)
    rows_v, rows_d = v2.reshape(-1, w).astype(F32), d2.reshape(-1, w).astype(F32)
    n_rows = rows_v.shape[0]
    pad = np.full((n_rows, w + 2 * span), np.inf, F32)
    pad[:, span : span + w] = rows_v
    out = rows_d.copy()
    ran, firsts = [], []
    i = np.arange(p)
    n_blk = kp // s
    for xs in range(0, w, segw):
        wu = min(segw, w - xs)
        buf = pad[:, span + xs - kp : span + xs - kp + span]  # x at buf[x - xs + kp]
        bmin = buf.reshape(n_rows, span // blk, blk).min(axis=2)  # keeps NaN
        n_grp = -(-wu // p)
        x0 = np.arange(n_grp) * p
        xs_g = x0[:, None] + i
        valid = xs_g < wu
        best = np.where(valid[None], rows_d[:, xs + np.minimum(xs_g, wu - 1)], F32(0))
        ran_u = np.zeros((n_rows, n_grp), np.int64)
        if n_blk > 0:
            c = kp + x0
            lw = buf[:, c[:, None] - s + np.arange(p + s)]
            rw = buf[:, c[:, None] + np.arange(p + s)]
            active = np.ones((n_rows, n_grp), bool)
            jlo, jhi = (c - reff) // blk, (c + p - 1 + reff) // blk
            smin = np.full((n_rows, n_grp), np.inf, F32)
            for t in range(n_grp):
                smin[:, t] = bmin[:, jlo[t] : jhi[t] + 1].min(axis=1)
            for k in range(n_blk):
                fd0 = F32(1 + k * s)
                lb = smin + fd0 * fd0
                active &= ~np.all(~valid[None] | (lb[..., None] >= best), axis=2)
                if not active.any():
                    break
                ran_u += active
                for j in range(min(s, reff - k * s)):
                    fx = fd0 + F32(j)
                    cand = np.minimum(lw[..., s - 1 + i - j], rw[..., i + 1 + j]) + fx * fx
                    best = np.where(active[..., None], np.minimum(best, cand), best)
                rw[..., :p] = rw[..., s : s + p].copy()
                lw[..., s:] = lw[..., :p].copy()
                if k + 1 < n_blk:
                    lw[..., :s] = buf[:, c[:, None] - (k + 2) * s + np.arange(s)]
                    rw[..., p:] = buf[:, c[:, None] + (k + 1) * s + p + np.arange(s)]
        out[:, xs + xs_g[valid]] = best[:, valid]
        ran.append(ran_u)
        firsts.append(xs + x0)
    return out.reshape(b, h, w), np.concatenate(ran, axis=1), np.concatenate(firsts)


def _hold_k5(v2, d2, radius, p=sc.K5_P, s=sc.K5_S, blk=sc.K5_BLOCK):
    got, ran, _ = k5_emulate(v2, d2, radius, p, s, blk)
    want = sc.edt_sweep_plain(torch.from_numpy(v2), torch.from_numpy(d2), radius).numpy()
    assert got.dtype == want.dtype == F32
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    assert np.array_equal(got[ok].view(np.int32), want[ok].view(np.int32))
    return ran


def _blob_inputs(n_sites, h, w, seed):
    _, lab = blob_sites(n_sites=n_sites, h=h, w=w, n_ch=1, n_cells=40, seed=seed)
    v2, d2 = _edt_sweep_inputs(torch.from_numpy(lab))
    return v2.numpy(), d2.numpy()


# (outputs a group, steps a block, values a block minimum): the source's,
# then the variants tools/k5_k4r_variants.py times
SHAPES = [(sc.K5_P, sc.K5_S, sc.K5_BLOCK), (8, 4, 8), (4, 4, 32), (16, 4, 16)]


@pytest.mark.parametrize("p,s,blk", SHAPES)
@pytest.mark.parametrize("radius", [1, 5, 48, 64])
def test_k5_walk_matches_the_plain_form_on_blob_sites(radius, p, s, blk):
    v2, d2 = _blob_inputs(2, 61, 150, seed=7)
    ran = _hold_k5(v2, d2, radius, p, s, blk)
    assert ran.max() <= -(-radius // s)


@pytest.mark.parametrize("p,s,blk", SHAPES)
@pytest.mark.parametrize("case", list(edt_adversarial_cases()))
def test_k5_walk_matches_the_plain_form_on_adversarial_rows(case, p, s, blk):
    v2, d2, radius = edt_adversarial_cases()[case]
    if d2 is None:  # labels: the sweep's inputs
        v2, d2 = (t.numpy() for t in _edt_sweep_inputs(torch.from_numpy(v2)))
    _hold_k5(v2, d2, radius, p, s, blk)


def test_k5_exit_stops_rows_of_one_label_and_empty_fields_at_once():
    """A row of one label (v2 = d2 = 1e18) runs no step; on a sparse
    field only the groups whose reach (the blocks within R of their
    pixels) holds an object's columns run, and in rows away from the
    object the groups beside its columns do."""
    v2 = np.full((1, 4, 1080), 1e18, F32)
    assert _hold_k5(v2, v2.copy(), 64).sum() == 0
    lab = torch.zeros((1, 200, 1080), dtype=torch.int32)
    lab[0, 90:100, 500:510] = 1
    v2, d2 = (t.numpy() for t in _edt_sweep_inputs(lab))
    _hold_k5(v2, d2, 64)
    _, ran, x0 = k5_emulate(v2, d2, 64)
    slack = 64 + sc.K5_BLOCK  # the reach, and at most a block beyond it
    far = (x0 + sc.K5_P - 1 + slack < 500) | (x0 - slack > 509)
    assert ran[:, far].sum() == 0
    beside = ((x0 >= 440) & (x0 < 496)) | ((x0 >= 512) & (x0 < 568))
    assert ran[:80][:, beside].min() > 0 and ran[110:][:, beside].min() > 0


def test_k5_walk_nan_in_reach_runs_all_of_r():
    v2 = np.random.default_rng(11).integers(0, 400, (1, 1, 256)).astype(F32)
    d2 = np.full_like(v2, 999.0)
    v2[0, 0, 40] = np.nan
    ran = _hold_k5(v2, d2, 64)
    assert ran[0, 0] == 64 // sc.K5_S  # a group whose reach holds the NaN never exits


@pytest.mark.parametrize("w,radius,reff,kp,span", [
    (1080, 64, 64, 64, 1216), (1537, 48, 48, 48, 1664), (1, 10, 0, 0, 32), (37, 64, 36, 40, 128),
    (1001, 13, 13, 16, 1056), (50, 0, 0, 0, 64),
])
def test_k5_geometry(w, radius, reff, kp, span):
    g = sc.edt_geometry(w, radius)
    assert (g.reff, g.kp, g.span) == (reff, kp, span)
    assert g.wp == -(-w // sc.K5_P) * sc.K5_P
    per_warp = 4 * (span + g.wp + span // sc.K5_BLOCK + g.wp // sc.K5_P)
    assert g.warps == sc.K5_WARPS and g.smem == g.warps * per_warp


def test_k5_geometry_refuses_rows_that_do_not_fit():
    assert sc.edt_geometry(26_000, 64).warps == 1
    with pytest.raises(ValueError, match="exceeds shared memory"):
        sc.edt_geometry(27_000, 64)
    with pytest.raises(ValueError, match="radius"):
        sc.edt_geometry(10, -1)


# ---------------------------------------------------------------------------
# K4 radial


def _k4r_vectors(b, n, plan):
    """{(cta, iteration, u, warp, lane): flat vector} as radial_sums.cu
    walks site b's 16-byte vectors, and its ragged head and tail pixels."""
    g_lo, g_hi = b * n, b * n + n
    a_lo = min((g_lo + 3) & ~3, g_hi)
    a_hi = max(g_hi & ~3, a_lo)
    ragged = list(range(g_lo, a_lo)) + list(range(a_hi, g_hi))
    step = sc.K4R_THREADS * sc.K4R_UNROLL
    walk = []
    for cta in range(plan.ctas):
        v0 = a_lo // 4 + cta * plan.vecs
        v1 = min(a_hi // 4, v0 + plan.vecs)
        for base in range(v0, v1, step):
            for u in range(sc.K4R_UNROLL):
                for warp in range(sc.K4R_THREADS // 32):
                    lanes = [base + u * sc.K4R_THREADS + warp * 32 + lane for lane in range(32)]
                    walk.append([v if v < v1 else None for v in lanes])
    return ragged, walk


@pytest.mark.parametrize("batch,n", [(8, 1_166_400), (3, 50_001), (2, 40_006), (1, 70_000),
                                     (2, 3), (5, 1), (4, 9_999), (1, 0), (3, 4_097)])
@pytest.mark.parametrize("resident", [132, 264, 528])
def test_k4r_plan_covers_every_pixel_once(batch, n, resident):
    plan = sc.radial_plan(batch, n, resident)
    assert 1 <= plan.ctas <= -(-resident // batch)
    if n // 4 >= sc.K4R_MIN_VECS * plan.ctas:
        assert plan.vecs >= sc.K4R_MIN_VECS
    for b in range(batch) if n < 100_000 else (0, batch - 1):
        ragged, walk = _k4r_vectors(b, n, plan)
        seen = ragged + [q for lanes in walk for v in lanes if v is not None
                         for q in range(4 * v, 4 * v + 4)]
        assert sorted(seen) == list(range(b * n, b * n + n))


def test_k4r_plan_at_the_main_path_shape():
    plan = sc.radial_plan(8, 1_166_400, 264)
    assert plan.ctas == 33 and plan.vecs == -(-291_600 // 33)
    with pytest.raises(ValueError, match="sites"):
        sc.radial_plan(65536, 10, 528)


def _k4r_vector_flushes(keys, vals):
    """k4r_vector for one warp: keys (32, 4) int (-1 inactive), vals (32,
    4, C) -> the (key, sums) it flushes: runs of equal keys in each lane,
    middle runs at once, a first run handed to the previous lane when it
    continues that lane's last run, the lanes' last runs summed over
    neighbouring lanes of equal key, flushed by each segment's last lane."""
    nv = 1 + vals.shape[2]
    flushes = []
    fk, lk = [-1] * 32, [-1] * 32
    fs, ls = np.zeros((32, nv)), np.zeros((32, nv))
    for lane in range(32):
        runs = 0
        for p in range(4):
            k = int(keys[lane, p])
            if k < 0:
                continue
            if k != lk[lane]:
                if lk[lane] >= 0:
                    if runs == 1:
                        fk[lane], fs[lane] = lk[lane], ls[lane].copy()
                    else:
                        flushes.append((lk[lane], ls[lane].copy()))
                lk[lane] = k
                runs += 1
                ls[lane] = 0.0
            ls[lane, 0] += 1.0
            ls[lane, 1:] += vals[lane, p]
    if max(lk) < 0:
        return flushes
    prev = [lk[max(lane - 1, 0)] if lane else lk[0] for lane in range(32)]
    for lane in range(31):
        if lk[lane] >= 0 and fk[lane + 1] == lk[lane]:
            ls[lane] += fs[lane + 1]
    for lane in range(32):
        if fk[lane] >= 0 and not (lane > 0 and fk[lane] == prev[lane]):
            flushes.append((fk[lane], fs[lane].copy()))
    heads = [lane == 0 or prev[lane] != lk[lane] for lane in range(32)]
    total = None
    for lane in range(32):
        total = ls[lane].copy() if heads[lane] else total + ls[lane]
        last = lane == 31 or heads[lane + 1]
        if last and lk[lane] >= 0:
            flushes.append((lk[lane], total))
    return flushes


def k4r_emulate(labels, codes, image, max_cells, n_codes, plan):
    """K4 radial's walk in f64: (B, n) labels and codes, (B, n, C) image
    -> (out (B, max_cells, n_codes, 1 + C), flushes a site)."""
    b, n = labels.shape
    n_ch = image.shape[2]
    flat_l, flat_c = labels.reshape(-1), codes.reshape(-1)
    flat_v = image.reshape(-1, n_ch).astype(np.float64)
    raw, code = flat_l.astype(np.int64), flat_c.astype(np.int64)
    key = np.where((raw > 0) & (code >= 0) & (code < n_codes),
                   np.where(raw < max_cells, raw, 0) * n_codes + code, -1)
    out = np.zeros((b, max_cells * n_codes, 1 + n_ch))
    n_flush = []
    for site in range(b):
        ragged, walk = _k4r_vectors(site, n, plan)
        flushes = [(int(key[g]), np.concatenate([[1.0], flat_v[g]])) for g in ragged if key[g] >= 0]
        for lanes in walk:
            px = np.array([[4 * v + q for q in range(4)] if v is not None else [-1] * 4
                           for v in lanes])
            k = np.where(px >= 0, key[np.maximum(px, 0)], -1)
            flushes += _k4r_vector_flushes(k, flat_v[np.maximum(px, 0)])
        for k, s in flushes:
            out[site, k] += s
        n_flush.append(len(flushes))
    return out.reshape(b, max_cells, n_codes, 1 + n_ch), n_flush


def _hold_k4r(labels, codes, image, max_cells, n_codes, resident=132):
    b, n = labels.shape
    got, n_flush = k4r_emulate(labels, codes, image, max_cells, n_codes,
                               sc.radial_plan(b, n, resident))
    want = sc.radial_sums_plain(torch.from_numpy(labels), torch.from_numpy(codes),
                                torch.from_numpy(image), max_cells, n_codes,
                                dtype=torch.float64).numpy()
    assert np.array_equal(got[..., 0], want[..., 0])
    assert np.all(np.abs(got - want) <= 1e-12 * np.abs(want) + 1e-12)
    return n_flush


@pytest.mark.parametrize("n_ch", [1, 2, 5, 8])
@pytest.mark.parametrize("max_cells", [16, 512])
def test_k4r_walk_matches_the_plain_form_on_blob_sites(n_ch, max_cells):
    img, lab = blob_sites(n_sites=2, h=61, w=73, n_ch=n_ch, n_cells=12, seed=n_ch,
                          overflow_id=600)
    rng = np.random.default_rng(max_cells)
    lab[0, :3] = -2  # negative ids are background
    b, n = 2, 61 * 73
    # rings of 8 wedges by distance from each object's centre, and a code
    # outside [0, 32) here and there
    codes = (np.arange(n) // 3 % 40 - 4).astype(np.int32)[None].repeat(2, 0)
    codes[:, rng.integers(0, n, 200)] = 32
    _hold_k4r(lab.reshape(b, n), codes, img.reshape(b, n, n_ch), max_cells, 32)


@pytest.mark.parametrize("case", RADIAL_CASES)
def test_k4r_walk_matches_the_plain_form_on_adversarial_sites(case):
    lab, codes, img, mc, n_codes = radial_adversarial_site(case, 3)
    b, n = lab.shape
    plan = sc.radial_plan(b, n, 132)
    n_flush = _hold_k4r(lab, codes, img, mc, n_codes)
    if case == "all background":
        assert n_flush == [0] * b
    if case == "one key":
        # one run a warp and vector: each warp's 32 vectors flush once
        warps = [sum(any(v is not None for v in lanes) for lanes in _k4r_vectors(s, n, plan)[1])
                 for s in range(b)]
        assert n_flush == warps


def test_k4r_merge_flushes_a_run_once_a_warp():
    """A run that spans lanes is flushed once, by the lane where it ends,
    whether its lanes hold one run or several."""
    keys = np.full((32, 4), -1)
    keys[0] = [1, 1, 2, 2]
    keys[1] = [2, 2, 2, 2]
    keys[2] = [2, 3, 3, 3]  # run 2 spans lanes 0-2, handed back from lane 2
    keys[3] = [3, 4, 4, 1]
    vals = np.ones((32, 4, 1))
    got = sorted((k, tuple(s)) for k, s in _k4r_vector_flushes(keys, vals))
    assert got == [(1, (1.0, 1.0)), (1, (2.0, 2.0)), (2, (7.0, 7.0)), (3, (4.0, 4.0)),
                   (4, (2.0, 2.0))]


def test_k4r_wrapper_copies_unaligned_inputs():
    lab = torch.arange(9, dtype=torch.int32)[1:].view(2, 4)
    codes = torch.zeros(9, dtype=torch.int32)[1:].view(2, 4)
    img = torch.ones((9, 1))[1:].view(2, 4, 1)
    out = torch.zeros((2, 16, 8, 2))
    args, (lab_c, codes_c, img_c) = sc.radial_args(lab, codes, img, out, sc.radial_plan(2, 4, 132))
    assert lab.data_ptr() % 16 and all(t.data_ptr() % 16 == 0 for t in (lab_c, codes_c, img_c))
    assert torch.equal(lab_c, lab) and args[0] == lab_c.data_ptr()
    assert args[4:] == (2, 4, 1, 16, 8, 1, 1)
