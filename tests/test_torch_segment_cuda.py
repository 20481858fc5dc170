"""Kernel contracts of K4-K6: the plain forms (what CPU tensors get)
against the reference.

* K4: the pass A, pass C, radial and pass E lane scans against the
  reference's lane functions (``fused_measure._make_lanes_a_fn_t`` /
  ``_make_lanes_c_fn_t``, ``colocalization._make_lanes_e_fn_t``, applied to
  whole images) summed by the reference's ``segment_matmul_sums``, to 2**-15
  of the per-label sum of |lane| (the reference's bf16 hi/lo split keeps
  ~16 significant bits per value; the port sums in f32); pixel counts
  exactly;
* K5 and K6: exactly against the Pallas kernels ``edt_sweep_pallas`` and
  ``pick2_pallas``, called directly (interpret mode on the CPU).

The CUDA kernels are held against these plain forms on the card by
``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saguaro_tpu.kernels import colocalization as ref_coloc
from saguaro_tpu.kernels import fused_measure as ref_fm
from saguaro_tpu.kernels import segment_pallas
from saguaro_tpu.kernels.onehot_reduce import segment_matmul_sums as ref_sums
from saguaro_tpu.kernels.zernike import _radial_coeffs as ref_coeffs
from saguaro_tpu_torch.kernels import segment_cuda as sc
from saguaro_tpu_torch.kernels.segment_reduce import perimeter_weight_image

from .torch_data import blob_sites, share_cpu_threads

share_cpu_threads()

MC = 16


@pytest.fixture(scope="module")
def site():
    img, lab = blob_sites(n_sites=2, h=40, w=48, n_ch=3, n_cells=6, seed=11)
    pw, border = perimeter_weight_image(torch.from_numpy(lab))
    return img, lab, pw.numpy(), border.numpy()


def _ref_lane_sums(lanes_t, lab, mc):
    """Reference sums of (n_lanes, N) lanes + per-label sum of |lane|."""
    flat = lab.reshape(-1)
    seg = np.where((flat > 0) & (flat < mc), flat, 0)
    sums = np.asarray(ref_sums(jnp.asarray(seg), jnp.asarray(lanes_t).T, mc))
    abs_sum = np.zeros((mc, lanes_t.shape[0]))
    np.add.at(abs_sum, seg, np.abs(np.asarray(lanes_t, np.float64)).T)
    return sums, abs_sum


def _base_rows(img, lab, border, s):
    h, w, n_ch = img.shape[1:]
    yy, xx = np.meshgrid(np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32), indexing="ij")
    in_c = (lab[s] > 0).reshape(-1).astype(np.float32)
    return (jnp.asarray(in_c), jnp.asarray(yy.reshape(-1)), jnp.asarray(xx.reshape(-1)),
            jnp.asarray(border[s].reshape(-1).astype(np.float32)),
            jnp.asarray(img[s].reshape(-1, n_ch).T))


@pytest.mark.parametrize("with_edge", [True, False])
def test_lane_sums_a_matches_reference_lanes(site, with_edge):
    img, lab, pw, border = site
    n_ch = img.shape[-1]
    got = sc.lane_sums_a_plain(
        torch.from_numpy(lab), torch.from_numpy(img), torch.from_numpy(pw),
        torch.from_numpy(border.astype(np.uint8)), MC, with_edge,
    ).numpy()
    fn = ref_fm._make_lanes_a_fn_t(with_edge, n_ch)
    for s in range(len(lab)):
        in_c, y_c, x_c, b_c, vr_c = _base_rows(img, lab, border, s)
        lanes = fn(None, None, (), in_c, y_c, x_c, b_c, jnp.asarray(pw[s].reshape(-1)), vr_c)
        want, abs_sum = _ref_lane_sums(np.asarray(lanes), lab[s], MC)
        assert got[s].shape == want.shape == (MC, sc.n_lanes_a(n_ch, with_edge))
        assert np.all(np.abs(got[s] - want) <= 2.0**-15 * abs_sum + 1e-6)
        np.testing.assert_array_equal(got[s][:, 0], want[:, 0])  # areas


@pytest.mark.parametrize(
    "moments,zernike,edge", [(True, True, True), (False, True, False), (True, False, True)]
)
def test_lane_sums_c_matches_reference_lanes(site, moments, zernike, edge):
    img, lab, pw, border = site
    b, h, w, n_ch = img.shape
    rng = np.random.default_rng(2)
    k_tab = sc.table_cols_c(n_ch, moments, zernike, edge)
    table = np.concatenate(
        [rng.uniform(0, min(h, w), (b, MC, 4 if moments else 2)),
         rng.uniform(2, 9, (b, MC, 1 if zernike else 0)),
         rng.uniform(80, 900, (b, MC, k_tab - (4 if moments else 2) - (1 if zernike else 0)))],
        axis=-1,
    ).astype(np.float32)
    table[:, 0] = 0.0  # slot 0 (background and overflow ids)
    got = sc.lane_sums_c_plain(
        torch.from_numpy(lab), torch.from_numpy(img), torch.from_numpy(border.astype(np.uint8)),
        torch.from_numpy(table), torch.from_numpy(ref_coeffs().astype(np.float32)),
        MC, moments, zernike, edge,
    ).numpy()
    fn = ref_fm._make_lanes_c_fn_t(moments, zernike, edge, False, n_ch, 0, False)
    consts = (jnp.asarray(ref_coeffs(), jnp.float32),) if zernike else ()
    for s in range(b):
        flat = lab[s].reshape(-1)
        seg = np.where((flat > 0) & (flat < MC), flat, 0)
        g = jnp.asarray(table[s][seg].T)
        in_c, y_c, x_c, b_c, vr_c = _base_rows(img, lab, border, s)
        lanes = fn(None, g, consts, in_c, y_c, x_c, b_c, vr_c)
        want, abs_sum = _ref_lane_sums(np.asarray(lanes), lab[s], MC)
        assert got[s].shape == want.shape == (MC, sc.n_lanes_c(n_ch, moments, zernike, edge))
        assert np.all(np.abs(got[s] - want) <= 2.0**-15 * abs_sum + 1e-5)


@pytest.mark.parametrize("n_rings", [4, 2])
def test_radial_sums_match_reference_lanes(site, n_rings):
    """The keyed (label, ring/wedge) sums against the reference's dense
    ring-masked and ring-and-wedge-masked lanes of pass C."""
    img, lab, pw, border = site
    b, h, w, n_ch = img.shape
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 8 * n_rings + 1, (b, h, w)).astype(np.int32)  # 8 * n_rings: excluded
    got = sc.radial_sums_plain(torch.from_numpy(lab).reshape(b, -1),
                               torch.from_numpy(codes).reshape(b, -1),
                               torch.from_numpy(img).reshape(b, -1, n_ch), MC, 8 * n_rings).numpy()
    table = rng.uniform(0, 40, (b, MC, 2 + n_ch)).astype(np.float32)
    fn = ref_fm._make_lanes_c_fn_t(False, False, False, True, n_ch, n_rings, True)
    n_base = 15 + n_ch + n_ch * (n_ch - 1) // 2
    for s in range(b):
        flat = lab[s].reshape(-1)
        seg = np.where((flat > 0) & (flat < MC), flat, 0)
        in_c, y_c, x_c, b_c, vr_c = _base_rows(img, lab, border, s)
        lanes = fn(None, jnp.asarray(table[s][seg].T), (), in_c, y_c, x_c, b_c, vr_c,
                   jnp.asarray(codes[s].reshape(-1).astype(np.float32)))
        want, abs_sum = _ref_lane_sums(np.asarray(lanes)[n_base:], lab[s], MC)
        ring = got[s].reshape(MC, n_rings, 8, 1 + n_ch)
        mine = np.concatenate([ring.sum(axis=2).reshape(MC, -1), ring.reshape(MC, -1)], axis=1)
        assert mine.shape == want.shape
        assert np.all(np.abs(mine - want) <= 2.0**-15 * abs_sum + 1e-6)
        np.testing.assert_array_equal(ring[..., 0].reshape(MC, -1), want[:, n_rings * (1 + n_ch):][:, ::1 + n_ch])


def test_lane_sums_e_matches_reference_lanes(site):
    img, lab, pw, border = site
    b, h, w, n_ch = img.shape
    pairs = tuple((a, c) for a in range(n_ch) for c in range(a + 1, n_ch))
    p = len(pairs)
    rng = np.random.default_rng(4)
    ranks = rng.integers(0, 400, (b, h * w, n_ch)).astype(np.float32)
    tff = rng.uniform(100, 300, (b, MC, n_ch)).astype(np.float32)
    consts = np.concatenate([rng.uniform(100, 300, (b, 2, p)), np.full((b, 1, p), 1 / 400.0)],
                            axis=1).astype(np.float32)
    got = sc.lane_sums_e_plain(
        torch.from_numpy(lab).reshape(b, -1), torch.from_numpy(img).reshape(b, -1, n_ch),
        torch.from_numpy(ranks), torch.from_numpy(tff), torch.from_numpy(consts), MC,
    ).numpy()
    fn = ref_coloc._make_lanes_e_fn_t(n_ch, pairs)
    for s in range(b):
        flat = lab[s].reshape(-1)
        seg = np.where((flat > 0) & (flat < MC), flat, 0)
        in_c, _, _, _, vr_c = _base_rows(img, lab, border, s)
        cst = tuple(jnp.asarray(consts[s, i][None]) for i in range(3))
        lanes = fn(None, jnp.asarray(tff[s][seg].T), cst, in_c, vr_c, jnp.asarray(ranks[s].T))
        want, abs_sum = _ref_lane_sums(np.asarray(lanes), lab[s], MC)
        assert got[s].shape == want.shape == (MC, sc.n_lanes_e(n_ch))
        assert np.all(np.abs(got[s] - want) <= 2.0**-15 * abs_sum + 1e-6)


@pytest.mark.parametrize("max_radius", [1, 7])
def test_edt_sweep_plain_matches_pallas(max_radius):
    from saguaro_tpu_torch.kernels.shape_extra import _edt_sweep_inputs

    _, lab = blob_sites(n_sites=2, h=24, w=40, n_ch=1, n_cells=6, seed=12)
    v2, d2 = _edt_sweep_inputs(torch.from_numpy(lab))
    got = sc.edt_sweep_plain(v2, d2, max_radius).numpy()
    for s in range(len(lab)):
        want = segment_pallas.edt_sweep_pallas(jnp.asarray(v2[s].numpy()), jnp.asarray(d2[s].numpy()),
                                               max_radius)
        np.testing.assert_array_equal(got[s], np.asarray(want))


def test_pick2_plain_matches_pallas():
    rng = np.random.default_rng(13)
    hi = rng.integers(0, 256, (2, 700, 2)).astype(np.int32)
    lo = rng.integers(0, 256, (2, 700, 2)).astype(np.int32)
    tables = rng.integers(0, 65536, (2, 2, 256, 256, 3)).astype(np.float32)
    got = sc.pick2_plain(torch.from_numpy(hi), torch.from_numpy(lo), torch.from_numpy(tables)).numpy()
    for s in range(2):
        want = segment_pallas.pick2_pallas(jnp.asarray(hi[s]), jnp.asarray(lo[s]),
                                           jnp.asarray(tables[s]))
        np.testing.assert_array_equal(got[s], np.asarray(want))
