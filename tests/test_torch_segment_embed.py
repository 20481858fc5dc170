"""Segment half of the engine: the port's SegmentEmbedEngine.segment_batch
and single-site segment against the reference engine's, with the same
CPnet weights (bridged from the reference's flax tree) in f32 on both
sides. Flow differences of ~1e-5 can move a rounded flow step only at
exact half-pixel ties, and the Euler steps of the single-site path are
summed as the reference sums them, so the labels are compared exactly.
The embed half is held in test_torch_embed."""

import numpy as np
import pytest
import torch

from saguaro_tpu.models.cellpose import CellposeConfig as RefCellposeConfig
from saguaro_tpu.models.effnetv2 import EffNetV2Config, StageSpec
from saguaro_tpu.pipeline.segment_embed import SegmentEmbedConfig as RefConfig
from saguaro_tpu.pipeline.segment_embed import SegmentEmbedEngine as RefEngine
from saguaro_tpu_torch.models.cellpose import CellposeConfig
from saguaro_tpu_torch.models.weights import cellpose_state_dict_from_flax
from saguaro_tpu_torch.pipeline.segment_embed import SegmentEmbedConfig, SegmentEmbedEngine

from .test_torch_cellpose import randomize_bn
from .torch_data import blob_sites, share_cpu_threads

share_cpu_threads()

TINY_EFFNET = EffNetV2Config(
    stem_filters=8,
    stages=(StageSpec("fused", 1, 3, 1, 8, 1),),
    head_filters=16,
    input_size=32,
)
FEATURES = (8, 16, 32, 64)
KW = dict(channels=["DNA", "GFP", "ER"], diameter=60.0, max_cells=64, min_size=5,
          cellprob_threshold=-1e9, flow_error_threshold=None)


@pytest.fixture(scope="module")
def engines():
    ref = RefEngine(RefConfig(
        **KW, box_size=16, embed_size=32, effnet=TINY_EFFNET,
        cellpose=RefCellposeConfig(features=FEATURES, tile=64, compute_dtype="float32"),
    ))
    ref.cell_vars = randomize_bn(ref.cell_vars, 5)
    # untrained weights give flows too weak to converge anywhere; a louder
    # head makes pixels travel and cluster, so both recoveries find masks
    ref.cell_vars["params"]["output"]["conv"]["kernel"] *= 30.0
    cfg = SegmentEmbedConfig(**KW, cellpose=CellposeConfig(features=FEATURES, tile=64, compute_dtype="float32"))
    port = SegmentEmbedEngine(
        cfg, cellpose_state_dict=cellpose_state_dict_from_flax(ref.cell_vars, cfg.cellpose),
        device="cpu",
    )
    return ref, port


@pytest.fixture(scope="module")
def images():
    img, _ = blob_sites(n_sites=2, h=100, w=110, n_ch=3, n_cells=10, seed=31)
    return img.astype(np.uint16)


def test_segment_batch_labels_equal(engines, images):
    ref, port = engines
    want = [np.asarray(l) for l in ref.segment_batch(images)]
    got = port.segment_batch(images)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), w)
    assert sum(int(w.max()) for w in want) >= 3  # the random net finds masks


def test_flow_qc_drops_the_same_masks(engines, monkeypatch):
    ref, port = engines
    monkeypatch.setattr(ref.cfg, "flow_error_threshold", 0.4)
    monkeypatch.setattr(port.cfg, "flow_error_threshold", 0.4)
    rng = np.random.default_rng(1)
    lab = np.zeros((2, 40, 40), np.int64)
    lab[:, 5:15, 5:15], lab[:, 20:32, 22:34] = 1, 2
    flows = rng.normal(0, 1, (2, 2, 40, 40)).astype(np.float32)
    want = ref._drop_bad_flow_masks_batch(list(lab), flows)
    got = port._drop_bad_flow_masks_batch(list(lab), torch.from_numpy(flows))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _hold_segment(ref, port, images, monkeypatch, flow_error_threshold, fill_holes):
    for eng in (ref, port):
        monkeypatch.setattr(eng.cfg, "flow_error_threshold", flow_error_threshold)
        monkeypatch.setattr(eng.cfg, "fill_holes", fill_holes)
    found = []
    for image in images:
        want = ref.segment(image)
        got = port.segment(image)
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        found.append(int(want.max()))
    return found


def test_single_site_segment_is_batch_of_one(engines, images, monkeypatch):
    """The single-site path (Euler recovery at the network resolution,
    the nearest upsample, hole filling, the min-size filter) against the
    reference engine's segment, at the fixture's settings: no flow QC,
    holes filled."""
    ref, port = engines
    assert sum(_hold_segment(ref, port, images, monkeypatch, None, True)) >= 3


@pytest.mark.parametrize("flow_error_threshold,fill_holes", [(24.0, True), (24.0, False), (None, False)])
def test_single_site_segment_matches_reference(engines, images, monkeypatch, flow_error_threshold,
                                               fill_holes):
    """As above with the flow-error QC on and holes left open. The random
    net's masks score flow errors of 23-36, so a threshold of 24 drops
    some of them and keeps others."""
    ref, port = engines
    found = _hold_segment(ref, port, images, monkeypatch, flow_error_threshold, fill_holes)
    assert sum(found) >= 3
    if flow_error_threshold is not None:
        monkeypatch.setattr(port.cfg, "flow_error_threshold", None)
        assert sum(int(port.segment(i).max()) for i in images) > sum(found)
