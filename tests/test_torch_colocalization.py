"""Thresholded colocalization (Manders, RWC, Costes): the port (plain forms
on the CPU) against the reference, per site of a batch.

* dense ranks, rank tables and distinct-value counts: exact (integer
  counts and cumsums), built by hand and by ``dense_rank_images``;
* Costes thresholds: the first channel's threshold (the stopping grid
  step) exact: the Pearson statistic of each step comes from exact joint
  counts and its sign decides the stop (both packages evaluate it in the
  same f32 sums, in the same order, so that a sign their rounding flips
  flips alike); the second channel's is the
  regression line at that step, whose coefficients are f32 sums over the
  pixels in another order, 1e-5 relative;
* the pass E sums: 2**-15 of the per-label sum of |lane| (the reference
  sums through a bf16 hi/lo split, the port in f32);
* the features: ratios of those sums, 1e-4 relative + 1e-4 of the column's
  largest value (``torch_data.feature_tolerance``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saguaro_tpu.kernels import colocalization as ref
from saguaro_tpu_torch.kernels import colocalization as port

from .torch_data import blob_sites, feature_tolerance, share_cpu_threads

share_cpu_threads()

MC = 16
PAIRS = ((0, 1), (0, 2), (1, 2))


@pytest.fixture(scope="module")
def sites():
    img, lab = blob_sites(n_sites=2, h=48, w=56, n_ch=3, n_cells=9, seed=51)
    # correlated channels so the Costes descent walks several steps
    img[..., 2] = np.round(0.6 * img[..., 1] + 0.4 * img[..., 2])
    cyto = np.where((lab == 0) & (np.roll(lab, 2, axis=2) > 0), np.roll(lab, 2, axis=2), 0)
    return img, lab, cyto.astype(np.int32)


def test_dense_ranks_exact(sites):
    img, lab, _ = sites
    b, h, w, n_ch = img.shape
    codes = img.reshape(b, -1, n_ch).astype(np.int32)
    inside = lab.reshape(b, -1) > 0
    hi, lo = torch.from_numpy(codes >> 8), torch.from_numpy(codes & 0xFF)
    cnts = port._value_count_tables(hi, lo, [torch.from_numpy(inside)])
    tabs, nds = zip(*(port._rank_table(cnts[:, c, ..., 0]) for c in range(n_ch)))
    ranks = port._pick_rows_mc(hi, lo, torch.stack(tabs, dim=1)[..., None])[..., 0]
    for s in range(b):
        r_ref, nd_ref = ref.dense_rank_images(jnp.asarray(codes[s]), jnp.asarray(inside[s]))
        np.testing.assert_array_equal(ranks[s].numpy(), np.asarray(r_ref))
        np.testing.assert_array_equal(torch.stack(nds, 1)[s].numpy(), np.asarray(nd_ref))


@pytest.mark.parametrize("mask", ["objects", "ring", "16-bit codes"])
def test_dense_rank_images_exact(sites, mask):
    """The reference's ``dense_rank_images`` as one call: ranks of every
    pixel and distinct values per channel, exactly, over the objects, a
    ring of cytoplasm, and codes spread over the whole 16-bit range."""
    img, lab, cyto = sites
    b, h, w, n_ch = img.shape
    codes = img.reshape(b, -1, n_ch).astype(np.int32)
    inside = lab.reshape(b, -1) > 0
    if mask == "ring":
        inside = cyto.reshape(b, -1) > 0
    elif mask == "16-bit codes":
        codes = np.random.default_rng(4).integers(0, 65536, codes.shape).astype(np.int32)
    ranks, n_distinct = port.dense_rank_images(torch.from_numpy(codes), torch.from_numpy(inside))
    assert ranks.shape == codes.shape and n_distinct.shape == (b, n_ch)
    for s in range(b):
        r_ref, nd_ref = ref.dense_rank_images(jnp.asarray(codes[s]), jnp.asarray(inside[s]))
        np.testing.assert_array_equal(ranks[s].numpy(), np.asarray(r_ref))
        np.testing.assert_array_equal(n_distinct[s].numpy(), np.asarray(nd_ref))
    assert float(n_distinct.min()) > 1


@pytest.mark.parametrize("scale,fast", [(255, True), (255, False), (63, True)])
def test_costes_thresholds_exact(sites, scale, fast):
    img, lab, _ = sites
    b, n_ch = len(img), img.shape[-1]
    vals = (img.reshape(b, -1, n_ch) / np.float32(65535.0) * np.float32(40.0)).astype(np.float32)
    vals = np.minimum(vals, np.float32(1.0))
    inside = lab.reshape(b, -1) > 0
    tf, ts = port.costes_thresholds(torch.from_numpy(vals), torch.from_numpy(inside), PAIRS,
                                    scale=scale, fast=fast)
    for s in range(b):
        rf, rs = ref.costes_thresholds(jnp.asarray(vals[s]), jnp.asarray(inside[s]), PAIRS,
                                       scale=scale, fast=fast)
        np.testing.assert_array_equal(tf[s].numpy(), np.asarray(rf))
        np.testing.assert_allclose(ts[s].numpy(), np.asarray(rs), rtol=1e-5, atol=1e-7)


def test_coloc_threshold_sums(sites):
    img, lab, _ = sites
    b, h, w, n_ch = img.shape
    rng = np.random.default_rng(5)
    vr = img.reshape(b, -1, n_ch)
    ranks = rng.integers(0, 500, vr.shape).astype(np.float32)
    tff = rng.uniform(100, 300, (b, MC, n_ch)).astype(np.float32)
    thr_f = rng.uniform(100, 300, (b, 3)).astype(np.float32)
    thr_s = rng.uniform(100, 300, (b, 3)).astype(np.float32)
    inv_r = np.full((b, 3), 1.0 / 500.0, np.float32)
    flat = lab.reshape(b, -1)
    got = port.coloc_threshold_sums(*(torch.from_numpy(a) for a in (flat, vr, ranks, tff, thr_f,
                                                                    thr_s, inv_r)), MC).numpy()
    for s in range(b):
        seg = np.where((flat[s] > 0) & (flat[s] < MC), flat[s], 0)
        inside = (flat[s] > 0).astype(np.float32)
        want = np.asarray(ref.coloc_threshold_sums(
            jnp.asarray(seg), jnp.asarray(inside), jnp.asarray(vr[s]), jnp.asarray(ranks[s]),
            jnp.asarray(tff[s]), jnp.asarray(thr_f[s]), jnp.asarray(thr_s[s]), jnp.asarray(inv_r[s]),
            PAIRS, MC))
        assert got[s].shape == want.shape == (MC, n_ch + 8 * len(PAIRS))
        mag = np.zeros_like(want, np.float64)
        np.add.at(mag, seg, np.abs(vr[s]).sum(1, keepdims=True).astype(np.float64))
        assert np.all(np.abs(got[s] - want) <= 2.0**-15 * mag + 1e-6)


def _multiset_inputs(img, nuc, cyto):
    """The three object sets (Cells = Nuclei + Cytoplasm) and each set's
    per-object channel maxima."""
    cells = np.where(cyto > 0, cyto, nuc)
    sets = {"Cells": cells, "Nuclei": nuc, "Cytoplasm": cyto}
    vmax = {}
    for nm, l in sets.items():
        v = np.full((len(img), MC, img.shape[-1]), -np.inf, np.float32)
        for s in range(len(img)):
            for k in np.unique(l[s][(l[s] > 0) & (l[s] < MC)]):
                v[s, k] = img[s][l[s] == k].max(0)
        vmax[nm] = v
    return sets, vmax


def _run_multiset(img, sets, vmax, integer_grid):
    return port.colocalization_features_multiset(
        torch.from_numpy(img), {k: torch.from_numpy(v) for k, v in sets.items()},
        {k: torch.from_numpy(v) for k, v in vmax.items()}, MC, integer_grid=integer_grid)


def _hold_multiset(got, img, sets, vmax, integer_grid):
    for s in range(len(img)):
        want = ref.colocalization_features_multiset(
            jnp.asarray(img[s]), {k: jnp.asarray(v[s]) for k, v in sets.items()},
            {k: jnp.asarray(v[s]) for k, v in vmax.items()}, MC, integer_grid=integer_grid)
        assert set(got) == set(want)
        for nm in want:
            for key, st in want[nm].items():
                if key == "costes_thr":
                    np.testing.assert_array_equal(got[nm][key][0][s].numpy(), np.asarray(st[0]))
                    np.testing.assert_allclose(got[nm][key][1][s].numpy(), np.asarray(st[1]),
                                               rtol=1e-5, atol=1e-7)
                    continue
                for stat, r in st.items():
                    r = np.asarray(r, np.float64)
                    g = got[nm][key][stat][s].numpy()
                    tol = feature_tolerance(stat, r, None, *img.shape[1:3])
                    assert np.all(np.abs(g - r) <= tol), (nm, key, stat, r, g)


@pytest.mark.parametrize("integer_grid", [True, False])
def test_multiset_matches_reference(sites, integer_grid):
    img, nuc, cyto = sites
    if not integer_grid:
        img = img * np.float32(0.37)
    sets, vmax = _multiset_inputs(img, nuc, cyto)
    _hold_multiset(_run_multiset(img, sets, vmax, integer_grid), img, sets, vmax, integer_grid)


def test_multiset_ranks_reach_pass_e_without_a_copy(sites, monkeypatch):
    """Each object set's ranks reach pass E as the rank pick's own
    set-major plane (``ranks_all[..., k]``, contiguous), not a copy; the
    outputs still equal the reference's."""
    img, nuc, cyto = sites
    sets, vmax = _multiset_inputs(img, nuc, cyto)
    picked, passed = [], []
    pick, lane_e = port._pick_rows_mc, port.sc.lane_sums_e_plain

    def pick_rec(*args):
        picked.append(pick(*args))
        return picked[-1]

    def lane_e_rec(labels, image, ranks, *args, **kw):
        passed.append(ranks.data_ptr())
        return lane_e(labels, image, ranks, *args, **kw)

    monkeypatch.setattr(port, "_pick_rows_mc", pick_rec)
    monkeypatch.setattr(port.sc, "lane_sums_e_plain", lane_e_rec)
    got = _run_multiset(img, sets, vmax, True)
    (ranks_all,) = picked
    assert ranks_all.shape[-1] == len(sets)
    assert passed == [ranks_all[..., k].data_ptr() for k in range(len(sets))]
    assert all(ranks_all[..., k].is_contiguous() for k in range(len(sets)))
    _hold_multiset(got, img, sets, vmax, True)


def test_costes_fine_scale_refines_each_set(sites):
    """With ``costes_fine_scale`` every object set's Costes thresholds come
    from the fine descent. Where CP's f64 descent (``cp_linear_costes_oracle``)
    stops with at least 10 of the set's pixels below its thresholds, the
    port's thresholds lie within 2 fine steps of it and of the reference's,
    and where the port's and the reference's are equal the C1/C2 columns
    agree within the feature tolerance. Where fewer pixels are left below
    (this fixture's correlated third pair walks down to the background's
    edge), the Pearson of 2 to 5 pixels decides the stop, from sums whose
    rounding differs on each side; there the thresholds are only held to be
    finite steps of the fine grid."""
    from .oracles import cp_linear_costes_oracle

    img, nuc, cyto = sites
    sets, vmax = _multiset_inputs(img, nuc, cyto)
    got = port.colocalization_features_multiset(
        torch.from_numpy(img), {k: torch.from_numpy(v) for k, v in sets.items()},
        {k: torch.from_numpy(v) for k, v in vmax.items()}, MC, costes_fine_scale=65535)
    step = 1.0 / 65535
    n_held = n_equal = 0
    for s in range(len(img)):
        want = ref.colocalization_features_multiset(
            jnp.asarray(img[s]), {k: jnp.asarray(v[s]) for k, v in sets.items()},
            {k: jnp.asarray(v[s]) for k, v in vmax.items()}, MC, costes_fine_scale=65535)
        vals = img[s].reshape(-1, img.shape[-1]).astype(np.float64) / 65535
        for nm in want:
            inside = sets[nm][s].reshape(-1) > 0
            tf, ts = (t[s].numpy() for t in got[nm]["costes_thr"])
            rf, rs = (np.asarray(t) for t in want[nm]["costes_thr"])
            assert np.all(np.isfinite(tf)) and np.all(np.abs(tf * 65535 - np.round(tf * 65535)) < 1e-2)
            for i, (a, c) in enumerate(PAIRS):
                cf, cs = cp_linear_costes_oracle(vals[inside, a], vals[inside, c], 65535, True)
                below = (vals[inside, a] < cf) | (vals[inside, c] < cs)
                if below.sum() < 10:
                    continue
                n_held += 1
                assert abs(tf[i] - cf) <= 2 * step + 1e-9, (nm, (a, c), tf[i] * 65535, cf * 65535)
                assert abs(tf[i] - rf[i]) <= 2 * step + 1e-9, (nm, (a, c), tf[i], rf[i])
                assert abs(ts[i] - rs[i]) <= abs(rs[i]) * 1e-3 + 2 * step
                if tf[i] != rf[i]:
                    continue
                n_equal += 1
                for stat in ("C1", "C2"):
                    r = np.asarray(want[nm][(a, c)][stat], np.float64)
                    g = got[nm][(a, c)][stat][s].numpy()
                    tol = feature_tolerance(stat, r, None, *img.shape[1:3])
                    assert np.all(np.abs(g - r) <= tol), (nm, (a, c), stat, r, g)
    assert n_held >= 10 and n_equal >= 10


def test_costes_of_an_empty_or_flat_mask_matches_reference():
    """A mask with no pixels (a site's empty Cytoplasm) or one whose
    channels do not vary has a NaN regression line: its second threshold
    reads as grid code 0, as the reference's XLA converts NaN, where the
    port once gathered at index -2**63 and failed the whole batch."""
    rng = np.random.default_rng(5)
    vals = rng.random((2, 300, 2)).astype(np.float32)
    vals[1] = 0.25
    inside = np.ones((2, 300), bool)
    inside[0] = False
    tf, ts = port.costes_thresholds(torch.from_numpy(vals), torch.from_numpy(inside), ((0, 1),))
    for s in range(2):
        rf, rs = ref.costes_thresholds(jnp.asarray(vals[s]), jnp.asarray(inside[s]), ((0, 1),))
        np.testing.assert_array_equal(tf[s].numpy(), np.asarray(rf))
        np.testing.assert_array_equal(ts[s].numpy(), np.asarray(rs))
    assert np.isneginf(tf[0, 0].item()) and np.isnan(ts[1, 0].item())


def test_costes_stops_where_the_reference_rounds(tmp_path):
    """The end-to-end screen's site (plate 2 at 6 h, third well): at the
    first grid step the exact Pearson of the pixels below is +0.0047, and
    the reference's f32 suffix sums round it to <= 0, so its descent stops
    there. The port evaluates the same f32 sums in the same order (XLA's
    blocked scan, its fused multiply-adds) and stops at the same step."""
    import zlib

    from saguaro_tpu_torch.io import tiff

    from .fixtures import make_fake_plate

    load_data, paths = make_fake_plate(str(tmp_path), n_wells=3, image_size=96,
                                       channels=("DNA", "GFP"), timepoint="6", plate="2",
                                       seed=zlib.crc32(b"2_6"))
    row = load_data.iloc[2]
    img = np.stack([np.asarray(tiff.imread(f"{paths['images']}/{row[f'FileName_{c}']}"), np.float32)
                    for c in ("DNA", "GFP")], -1).reshape(-1, 2)
    inside = paths["gt_masks"][(row["Metadata_Well"], row["Metadata_Site"])].reshape(-1) > 0
    vals = img / img[inside].max()
    _, _, (_, thr_k, prev_k) = port.costes_thresholds(
        torch.from_numpy(vals[None]), torch.from_numpy(inside[None]), ((0, 1),),
        return_bracket=True)
    _, _, (regs, r_thr, r_prev) = ref.costes_thresholds(
        jnp.asarray(vals), jnp.asarray(inside), ((0, 1),), return_bracket=True)
    assert float(r_thr[0]) == float(r_prev[0]) == 255.0
    np.testing.assert_array_equal(thr_k[0].numpy(), np.asarray(r_thr))
    np.testing.assert_array_equal(prev_k[0].numpy(), np.asarray(r_prev))
    # the exact statistic at that step is positive: only the rounding stops it
    codes = np.clip(np.floor(vals[inside] * 255), 0, 255)
    slope, icept = (float(v) for v in np.asarray(regs)[0])
    jb = np.ceil((slope * 1.0 + icept) * 255)
    below = ~((codes[:, 0] >= 255) & (codes[:, 1] >= jb))
    assert 0.0 < np.corrcoef(codes[below, 0], codes[below, 1])[0, 1] < 0.01
