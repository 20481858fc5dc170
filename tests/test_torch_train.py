"""Segmenter training (``models/cellpose_train.py``, ``flow_loss`` and
``train_step``) against the reference, on the CPU: ``synthetic_nuclei``
draws the same images; ``masks_to_flows`` equals the reference's flows to
1e-5 (its log1p is XLA's, bit for bit) and passes the reference's own
checks; ``flow_loss`` agrees to 1e-6 relative; 5 f32 training steps from
the reference's initial weights give its losses to 1e-4 relative and a net
whose outputs on a held-out tile agree to 1e-3 of their scale. Learning
itself is shown at full width on the card (chip_smoke.py's training
phase); here the reference's slow test has its counterpart."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saguaro_tpu.models import cellpose_train as ref_train
from saguaro_tpu.models.cellpose import CellposeConfig as RefConfig
from saguaro_tpu.models.cellpose import CellposeUNet as RefUNet
from saguaro_tpu.models.cellpose import flow_loss as ref_flow_loss
from saguaro_tpu.models.cellpose import init_cellpose as ref_init
from saguaro_tpu_torch.device import full_f32
from saguaro_tpu_torch.kernels.flow_ode import compute_masks
from saguaro_tpu_torch.models import cellpose_train
from saguaro_tpu_torch.models.cellpose import CellposeConfig, CellposeUNet, flow_loss, segment_image
from saguaro_tpu_torch.models.cellpose_weights import cellpose_state_dict_from_flax

from .torch_data import share_cpu_threads

share_cpu_threads()

FEATURES = (4, 8, 16, 32)
TILE = 32
# held-out outputs of the two trained nets: their weights moved by 5 Adam
# steps each, whose per-weight updates are about lr in size whatever the
# gradient, so summation-order differences of near-zero gradients move a
# few weights by up to 2 lr; that stays well inside 1e-3 of the outputs'
# scale
OUT_RTOL = 1e-3


def _iou_matched(gt: np.ndarray, pred: np.ndarray) -> float:
    """Mean best-match IoU over GT cells (tests/test_train.py's)."""
    ious = []
    for lab in np.unique(gt[gt > 0]):
        m = gt == lab
        ids, counts = np.unique(pred[m], return_counts=True)
        ids, counts = ids[ids > 0], counts[ids > 0]
        if ids.size == 0:
            ious.append(0.0)
            continue
        best = ids[np.argmax(counts)]
        p = pred == best
        ious.append(np.logical_and(m, p).sum() / np.logical_or(m, p).sum())
    return float(np.mean(ious)) if ious else 0.0


@pytest.mark.parametrize("seed,size,n_cells", [(0, 96, 4), (1, 128, 8), (7, 64, 3)])
def test_synthetic_nuclei_equal_bit_for_bit(seed, size, n_cells):
    img_r, lab_r = ref_train.synthetic_nuclei(np.random.default_rng(seed), size=size, n_cells=n_cells)
    img_p, lab_p = cellpose_train.synthetic_nuclei(np.random.default_rng(seed), size=size, n_cells=n_cells)
    assert img_p.dtype == img_r.dtype and lab_p.dtype == lab_r.dtype
    np.testing.assert_array_equal(img_p, img_r)
    np.testing.assert_array_equal(lab_p, lab_r)


@pytest.mark.parametrize("seed,size,n_cells", [(0, 96, 4), (3, 96, 8)])
def test_masks_to_flows_matches_reference(seed, size, n_cells):
    """Max abs 1e-5 (the flows are unit vectors): the heat is equal to the
    bit, and the normalisation differs by an ulp where it does."""
    _, labels = ref_train.synthetic_nuclei(np.random.default_rng(seed), size=size, n_cells=n_cells)
    want = ref_train.masks_to_flows(labels)
    got = cellpose_train.masks_to_flows(labels, device="cpu")
    assert got.shape == want.shape == (2, size, size) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_masks_to_flows_explicit_iterations_match():
    _, labels = ref_train.synthetic_nuclei(np.random.default_rng(5), size=64, n_cells=3)
    np.testing.assert_allclose(cellpose_train.masks_to_flows(labels, n_iters=7, device="cpu"),
                               ref_train.masks_to_flows(labels, n_iters=7), rtol=0, atol=1e-5)


def test_flows_point_inward():
    """The reference's test_flows_point_inward, on the port's flows and
    the port's Euler recovery."""
    _, labels = cellpose_train.synthetic_nuclei(np.random.default_rng(0), size=96, n_cells=4)
    flows = cellpose_train.masks_to_flows(labels, device="cpu")
    assert flows.shape == (2, 96, 96)
    assert np.abs(flows[:, labels == 0]).max() == 0
    cellprob = np.where(labels > 0, 5.0, -5.0).astype(np.float32)
    rec = compute_masks(flows * 5.0, cellprob, n_iters=80, min_size=5, device="cpu")
    assert _iou_matched(labels, rec) > 0.85


@pytest.mark.parametrize("lo,hi", [(0.0, 1e-3), (0.0, 0.5), (0.3, 3.0), (1.0, 1000.0)])
def test_log1p_is_xlas_bit_for_bit(lo, hi):
    x = np.random.default_rng(int(hi * 7)).uniform(lo, hi, 1 << 16).astype(np.float32)
    want = np.asarray(jax.jit(jnp.log1p)(x))
    got = cellpose_train._log1p_xla(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_flow_loss_matches_reference():
    rng = np.random.default_rng(2)
    pred = rng.normal(0, 3, (3, 16, 20, 3)).astype(np.float32)
    flows = rng.normal(0, 1, (3, 16, 20, 2)).astype(np.float32)
    prob = (rng.uniform(size=(3, 16, 20)) > 0.6).astype(np.float32)
    want = float(ref_flow_loss(jnp.asarray(pred), jnp.asarray(flows), jnp.asarray(prob)))
    got = float(flow_loss(torch.from_numpy(pred), torch.from_numpy(flows), torch.from_numpy(prob)))
    assert abs(got - want) <= 1e-6 * abs(want)


def _training_set(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    images, flows, probs = [], [], []
    for _ in range(n):
        img, labels = ref_train.synthetic_nuclei(rng, size=TILE, n_cells=2, radius_range=(4, 7))
        images.append(img)
        flows.append(ref_train.masks_to_flows(labels))
        probs.append((labels > 0).astype(np.float32))
    return np.stack(images), np.stack(flows), np.stack(probs)


@pytest.fixture(scope="module")
def trained(request):
    """5 f32 steps of both packages from the reference's initial weights
    (the port's init_cellpose patched to load them)."""
    images, flows, probs = _training_set(6)
    ref_cfg = RefConfig(tile=TILE, features=FEATURES, compute_dtype="float32")
    cfg = CellposeConfig(tile=TILE, features=FEATURES, compute_dtype="float32")
    with jax.default_matmul_precision("highest"):
        want = ref_train.train_cellpose(images, flows, probs, ref_cfg, n_steps=5, batch_size=4,
                                        learning_rate=1e-3, seed=0)
    _, start = ref_init(ref_cfg, seed=0)
    start = cellpose_state_dict_from_flax(jax.tree.map(np.asarray, start), cfg)
    mp = pytest.MonkeyPatch()
    real_init = cellpose_train.init_cellpose

    def init_from_reference(config, seed=0, device=None):
        model = real_init(config, seed=seed, device=device)
        model.load_state_dict(start)
        return model

    mp.setattr(cellpose_train, "init_cellpose", init_from_reference)
    request.addfinalizer(mp.undo)
    with full_f32():
        got = cellpose_train.train_cellpose(images, flows, probs, cfg, n_steps=5, batch_size=4,
                                            learning_rate=1e-3, seed=0, device="cpu")
    return want, got, ref_cfg, cfg


def test_training_losses_match_reference(trained):
    want, got, _, _ = trained
    assert len(got.losses) == len(got.step_seconds) == 5
    assert all(isinstance(v, float) for v in got.losses)
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4)
    assert got.losses[-1] < got.losses[0]


def test_trained_nets_agree_on_a_held_out_tile(trained):
    want, got, ref_cfg, cfg = trained
    img, _ = ref_train.synthetic_nuclei(np.random.default_rng(9), size=TILE, n_cells=2, radius_range=(4, 7))
    with jax.default_matmul_precision("highest"):
        out_ref = np.asarray(RefUNet(ref_cfg).apply(want.variables, img[None]))
    net = CellposeUNet(cfg).eval()
    net.load_state_dict(got.variables)
    with torch.no_grad(), full_f32():
        out = net(torch.from_numpy(img[None])).numpy()
    np.testing.assert_allclose(out, out_ref, rtol=0, atol=OUT_RTOL * np.abs(out_ref).max())


def test_training_keeps_batchnorm_statistics(trained):
    """The BatchNorms normalise by their stored statistics, untouched by the
    steps, as the reference's fixed batch_stats."""
    _, got, _, cfg = trained
    _, start = ref_init(RefConfig(tile=TILE, features=FEATURES, compute_dtype="float32"), seed=0)
    start = cellpose_state_dict_from_flax(jax.tree.map(np.asarray, start), cfg)
    for k, v in start.items():
        if "running_" in k:
            torch.testing.assert_close(got.variables[k], v, rtol=0, atol=0)


def test_mesh_is_refused():
    images, flows, probs = _training_set(1)
    with pytest.raises(NotImplementedError, match="mesh"):
        cellpose_train.train_cellpose(images, flows, probs, CellposeConfig(tile=TILE, features=FEATURES),
                                      n_steps=1, mesh=object(), device="cpu")


@pytest.mark.slow
def test_trained_net_segments():
    """The reference's test_trained_net_segments (tests/test_train.py:51):
    300 steps of 8 on 24 synthetic 96² images, then the held-out image's
    masks, at the CLI's learning rate of 1e-3 with torch on 2 threads (loss
    2.49 -> 0.97, IoU 0.69 in tools/train_seeds_cpu.py's run of this case).

    The reference's 5e-3 sits at the edge of stability for both packages:
    the reference's own loop stays on a plateau of loss 2.0 from seed 3
    (2.04 at step 300, IoU 0), and the port's result from seed 1 changes
    with the CPU threads' summation order (IoU 0.89 on 6 threads, 0.28 on
    1), all by tools/train_seeds_cpu.py. At full width on the card 5e-3
    diverges and 1e-3 learns (tools/train_lr_sweep.py). So this test takes
    1e-3 and pins the thread count, so that a run repeats."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        _train_and_segment()
    finally:
        torch.set_num_threads(before)


def _train_and_segment():
    rng = np.random.default_rng(1)
    size = 96
    cfg = CellposeConfig(tile=size, features=(8, 16, 32, 64), n_channels=2, flow_iters=80)
    images, flow_ts, prob_ts = [], [], []
    for _ in range(24):
        img, labels = cellpose_train.synthetic_nuclei(rng, size=size, n_cells=5)
        images.append(img)
        flow_ts.append(cellpose_train.masks_to_flows(labels, device="cpu"))
        prob_ts.append((labels > 0).astype(np.float32))
    result = cellpose_train.train_cellpose(
        np.stack(images), np.stack(flow_ts), np.stack(prob_ts),
        cfg, n_steps=300, batch_size=8, learning_rate=1e-3, device="cpu",
    )
    assert result.losses[-1] < result.losses[0] * 0.5

    net = CellposeUNet(cfg).eval()
    net.load_state_dict(result.variables)
    test_img, test_labels = cellpose_train.synthetic_nuclei(rng, size=size, n_cells=5)
    flows, cellprob, _ = segment_image(net, torch.from_numpy(test_img), cfg, diameter=None)
    masks = compute_masks(flows.numpy(), cellprob.numpy(), n_iters=80, min_size=10, device="cpu")
    iou = _iou_matched(test_labels, masks)
    assert iou > 0.5, f"trained net IoU too low: {iou}"
