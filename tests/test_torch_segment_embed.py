"""Segment half of the engine: the port's SegmentEmbedEngine.segment_batch
against the reference engine's, with the same CPnet weights (bridged from
the reference's flax tree) in f32 on both sides. Flow differences of
~1e-5 can move a rounded flow step only at exact half-pixel ties, so the
labels are compared exactly; the embed half is refused."""

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
from .torch_data import blob_sites

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


def test_single_site_segment_is_batch_of_one(engines, images):
    _, port = engines
    np.testing.assert_array_equal(port.segment(images[0]), port.segment_batch(images[:1])[0].numpy())


def test_embed_half_refused(engines):
    _, port = engines
    with pytest.raises(NotImplementedError, match="embed"):
        port.embed_sites_pooled(None, None)
