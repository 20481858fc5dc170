"""Mask recovery: the port against the reference on the same flows —
pointer-jumping positions, seed clustering and the recovered labels are
exactly equal (integer arithmetic after the same f32 rounding). Euler
positions are held to 1e-3 px after 200 steps, on centroid flows and on
random ones, whose diverging field grows any last-bit difference of a
step into pixels; the labels they give are equal. The flow QC errors
agree to 1e-5 (f32 scatter sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saguaro_tpu.kernels import flow_ode as ref
from saguaro_tpu_torch.kernels import flow_ode as port

from .torch_data import blob_sites, share_cpu_threads

share_cpu_threads()


@pytest.fixture(scope="module")
def flows():
    """Reference-style network flows: 5x centroid flows of ground-truth
    blobs plus noise, and a cellprob logit."""
    _, lab = blob_sites(n_sites=2, h=60, w=64, n_ch=1, n_cells=8, seed=21, overflow_id=None)
    rng = np.random.default_rng(0)
    f = np.stack([ref.centroid_flows(l) for l in lab]) * 5.0
    f = (f + rng.normal(0, 0.3, f.shape)).astype(np.float32)
    prob = np.where(lab > 0, 4.0, -4.0).astype(np.float32) + rng.normal(0, 1, lab.shape).astype(np.float32)
    return lab, f, prob


def test_centroid_flows_equal(flows):
    lab = flows[0]
    np.testing.assert_array_equal(port.centroid_flows(lab[0]), ref.centroid_flows(lab[0]))


def test_follow_flows_pointer_exact(flows):
    _, f, prob = flows
    active = prob > 0
    got = port.follow_flows_pointer(torch.from_numpy(f / 5.0), torch.from_numpy(active), 8).numpy()
    want = np.asarray(jax.vmap(lambda a, b: ref.follow_flows_pointer(a, b, 8))(
        jnp.asarray(f / 5.0), jnp.asarray(active)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("field", ["centroid", "random"])
def test_follow_flows_matches_reference(flows, field):
    lab, f, _ = flows
    if field == "centroid":
        f = np.stack([ref.centroid_flows(lb) for lb in lab])
    else:
        f = np.random.default_rng(3).normal(0, 1, f.shape).astype(np.float32)
    active = lab > 0
    got = port.follow_flows(torch.from_numpy(f), torch.from_numpy(active), 200).numpy()
    want = np.stack([np.asarray(ref.follow_flows(jnp.asarray(f[s]), jnp.asarray(active[s]), 200))
                     for s in range(len(f))])
    assert got.shape == want.shape == (len(f), 2, *lab.shape[1:])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    start = np.stack(np.meshgrid(np.arange(lab.shape[1]), np.arange(lab.shape[2]), indexing="ij"))
    for s in range(len(f)):
        np.testing.assert_array_equal(got[s][:, ~active[s]], start[:, ~active[s]])  # fixed
        assert np.abs(got[s][:, active[s]] - start[:, active[s]]).max() > 2.0  # moved


def test_compute_masks_euler_recovers_disks():
    """Euler recovery on ground-truth disks' centroid flows: the port's
    labels equal the reference's and each disk comes back whole."""
    h, w = 48, 56
    yy, xx = np.mgrid[:h, :w]
    gt = np.zeros((h, w), np.int32)
    for k, (cy, cx, r) in enumerate([(12, 12, 7), (14, 38, 8), (34, 20, 9), (36, 44, 6)], 1):
        gt[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = k
    f = (ref.centroid_flows(gt) * 5.0).astype(np.float32)
    prob = np.where(gt > 0, 5.0, -5.0).astype(np.float32)
    got = port.compute_masks(f, prob, min_size=0, device="cpu")
    want = ref.compute_masks(f, prob, min_size=0)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and int(got.max()) == 4
    for k in range(1, 5):
        ids, cnt = np.unique(got[gt == k], return_counts=True)
        assert len(ids) == 1 and ids[0] > 0 and cnt[0] == (got == ids[0]).sum() == (gt == k).sum()
    t = port.compute_masks(torch.from_numpy(f), torch.from_numpy(prob), min_size=0)
    np.testing.assert_array_equal(t, want)


@pytest.mark.parametrize("method", ["pointer", "euler"])
def test_compute_masks_batch_method_matches_reference(flows, method):
    lab, f, prob = flows
    got = port.compute_masks_batch(f, prob, n_iters=120, method=method, device="cpu")
    want = ref.compute_masks_batch(f, prob, n_iters=120, method=method)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert max(int(g.max()) for g in got) >= 5
    one = port.compute_masks(f[1], prob[1], n_iters=120, method=method, device="cpu")
    np.testing.assert_array_equal(one, want[1])
    with pytest.raises(ValueError, match="method"):
        port.compute_masks_batch(f, prob, method="rk4", device="cpu")


def test_masks_from_flows_exact(flows):
    _, f, prob = flows
    active = prob > 0
    pos = np.array(jax.vmap(lambda a, b: ref.follow_flows_pointer(a, b, 8))(
        jnp.asarray(f / 5.0), jnp.asarray(active)))
    got = port.masks_from_flows(torch.from_numpy(pos), torch.from_numpy(active)).numpy()
    for s in range(len(f)):
        np.testing.assert_array_equal(got[s], np.asarray(ref.masks_from_flows(pos[s], active[s])))


@pytest.mark.parametrize("min_size", [0, 15])
def test_compute_masks_batch_exact_on_reference_flows(flows, min_size):
    lab, f, prob = flows
    got = port.compute_masks_batch(f, prob, min_size=min_size, device="cpu")
    want = ref.compute_masks_batch(f, prob, min_size=min_size)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert max(int(g.max()) for g in got) >= 5  # cells were found


def test_compute_masks_keeps_tensor_device(flows):
    _, f, prob = flows
    got = port.compute_masks_batch(torch.from_numpy(f), torch.from_numpy(prob))
    np.testing.assert_array_equal(got[0], port.compute_masks_batch(f, prob, device="cpu")[0])


def test_flow_qc_error_close(flows):
    lab, f, _ = flows
    err, cnt = port.flow_qc_error_batch(torch.from_numpy(lab), torch.from_numpy(f / 5.0), 16)
    e_ref, c_ref = jax.vmap(lambda l, fl: ref.flow_qc_error(l, fl, 16))(jnp.asarray(lab), jnp.asarray(f / 5.0))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(c_ref))
    np.testing.assert_allclose(err.numpy(), np.asarray(e_ref), rtol=1e-5, atol=1e-6)
    e1, c1 = port.flow_qc_error(torch.from_numpy(lab[0]), torch.from_numpy(f[0] / 5.0), 16)
    np.testing.assert_array_equal(e1.numpy(), err[0].numpy())


def test_host_post_passes_equal(flows):
    lab = flows[0][0].copy()
    lab[lab == 3] = 0
    lab[20:22, 20:22] = 0  # holes for the fill
    np.testing.assert_array_equal(port.relabel_consecutive(lab, 10), ref.relabel_consecutive(lab, 10))
    np.testing.assert_array_equal(port.fill_label_holes(lab), ref.fill_label_holes(lab))
