"""K4 lane contract: the plain pass A / pass C lane scans (what CPU
tensors get) against the reference's lane functions
(``fused_measure._make_lanes_a_fn_t`` / ``_make_lanes_c_fn_t``, applied to
whole images) summed by the reference's ``segment_matmul_sums``.
Tolerance: 2**-15 of the per-label sum of |lane| (the reference's bf16
hi/lo split keeps ~16 significant bits per value; the port sums in f32).
The CUDA kernels are held against these plain forms on the card by
``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saguaro_tpu.kernels import fused_measure as ref_fm
from saguaro_tpu.kernels.onehot_reduce import segment_matmul_sums as ref_sums
from saguaro_tpu.kernels.zernike import _radial_coeffs as ref_coeffs
from saguaro_tpu_torch.kernels import segment_cuda as sc
from saguaro_tpu_torch.kernels.segment_reduce import perimeter_weight_image

from .torch_data import blob_sites

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
