"""Mask recovery: the port against the reference on the same flows —
pointer-jumping positions, seed clustering and the recovered labels are
exactly equal (integer arithmetic after the same f32 rounding). The flow
QC errors agree to 1e-5 (f32 scatter sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saguaro_tpu.kernels import flow_ode as ref
from saguaro_tpu_torch.kernels import flow_ode as port

from .torch_data import blob_sites


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
