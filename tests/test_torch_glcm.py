"""Texture: the port (plain forms on the CPU) against the reference.
Grey levels and the co-occurrence counts are exact, so the normalized GLCMs
are bit-equal; the 13 Haralick statistics are closed forms over them,
equal to 1e-5 relative + 1e-6 (summation order of their reductions). The
one-channel ``object_glcm`` (own ranges, given stats, given grey levels)
and the plain ``object_glcm_scatter`` are bit-equal to the reference's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saguaro_tpu.kernels import glcm as ref
from saguaro_tpu.kernels.onehot_reduce import mxu_take_t as ref_take_t
from saguaro_tpu_torch.kernels import glcm as port
from saguaro_tpu_torch.kernels.onehot_reduce import mxu_take_t
from saguaro_tpu_torch.kernels.segment_reduce import _flat

from .torch_data import blob_sites, share_cpu_threads

share_cpu_threads()

MC = 16


@pytest.fixture(scope="module")
def sites():
    img, lab = blob_sites(n_sites=2, h=48, w=56, n_ch=2, n_cells=8, seed=31)
    b, h, w, n_ch = img.shape
    # per-object ranges as the measurement gathers them (vmin, vrange)
    vmin = np.zeros((b, MC, n_ch), np.float32)
    vmax = np.zeros((b, MC, n_ch), np.float32)
    for s in range(b):
        for k in range(1, MC):
            m = lab[s] == k
            if m.any():
                vmin[s, k], vmax[s, k] = img[s][m].min(0), img[s][m].max(0)
    vrange = np.maximum(vmax - vmin, 1e-12)
    return img, lab, vmin, vrange


@pytest.mark.parametrize("levels,distance", [(16, 3), (8, 1)])
def test_glcm_and_haralick(sites, levels, distance):
    img, lab, vmin, vrange = sites
    b, h, w, n_ch = img.shape
    lab_t = torch.from_numpy(lab)
    g = mxu_take_t(torch.from_numpy(np.concatenate([vmin, vrange], 2)), _flat(lab_t, MC), MC)
    q = port.quantize_channels(torch.from_numpy(img), lab_t, levels, (g[:, :n_ch], g[:, n_ch:]))
    glcm = port.object_glcm_multichannel(lab_t, MC, levels, distance, q)
    har = port.haralick_features(glcm)
    assert set(har) == set(port.HARALICK_NAMES) == set(ref.HARALICK_NAMES)
    for s in range(b):
        seg = np.where((lab[s] > 0) & (lab[s] < MC), lab[s], 0).reshape(-1)
        gr = ref_take_t(jnp.asarray(np.concatenate([vmin[s], vrange[s]], 1)), jnp.asarray(seg), MC)
        q_ref = ref.quantize_channels(jnp.asarray(img[s]), jnp.asarray(lab[s]), MC, levels,
                                      ranges=(gr[:n_ch], gr[n_ch:]))
        np.testing.assert_array_equal(q[s].numpy(), np.asarray(q_ref))
        want = ref.object_glcm_multichannel(jnp.asarray(img[s]), jnp.asarray(lab[s]), MC, levels,
                                            distance, quantized=q_ref)
        np.testing.assert_array_equal(glcm[s].numpy(), np.asarray(want))
        har_ref = ref.haralick_features(want)
        for k in ref.HARALICK_NAMES:
            np.testing.assert_allclose(har[k][s].numpy(), np.asarray(har_ref[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)


# --------------------------------------------------------------------------
# The one-channel forms: object_glcm (the fused histogram) with its own
# ranges, with given stats and with given grey levels, and the plain
# scatter form; normalized GLCMs bit-equal to the reference's


def _site_args(img, lab, s, c=0):
    return jnp.asarray(img[s, ..., c]), jnp.asarray(lab[s])


@pytest.mark.parametrize("mode", ["own ranges", "stats", "quantized"])
def test_object_glcm_matches_reference(sites, mode):
    img, lab, vmin, vrange = sites
    b = len(lab)
    kw_port, kw_ref = {}, [{} for _ in range(b)]
    if mode == "stats":
        vmax = vmin + vrange
        kw_port["stats"] = (torch.from_numpy(vmin[..., 1]), torch.from_numpy(vmax[..., 1]))
        kw_ref = [{"stats": (jnp.asarray(vmin[s, :, 1]), jnp.asarray(vmax[s, :, 1]))} for s in range(b)]
    elif mode == "quantized":
        q = np.random.default_rng(2).integers(0, 16, lab.shape).astype(np.int32)
        kw_port["quantized"] = torch.from_numpy(q)
        kw_ref = [{"quantized": jnp.asarray(q[s])} for s in range(b)]
    got = port.object_glcm(torch.from_numpy(img[..., 1]), torch.from_numpy(lab), MC, 16, 3, **kw_port)
    assert got.shape == (b, 4, MC, 16, 16)
    for s in range(b):
        want = ref.object_glcm(*_site_args(img, lab, s, 1), MC, 16, 3, **kw_ref[s])
        np.testing.assert_array_equal(got[s].numpy(), np.asarray(want))
    assert got.sum() > 0


@pytest.mark.parametrize("levels,distance", [(16, 3), (8, 1)])
def test_object_glcm_scatter_matches_reference(sites, levels, distance):
    img, lab, _, _ = sites
    got = port.object_glcm_scatter(torch.from_numpy(img[..., 0]), torch.from_numpy(lab), MC,
                                   levels, distance)
    for s in range(len(lab)):
        want = ref.object_glcm_scatter(*_site_args(img, lab, s), MC, levels, distance)
        np.testing.assert_array_equal(got[s].numpy(), np.asarray(want))
    fused = port.object_glcm(torch.from_numpy(img[..., 0]), torch.from_numpy(lab), MC, levels,
                             distance)
    np.testing.assert_array_equal(got.numpy(), fused.numpy())
