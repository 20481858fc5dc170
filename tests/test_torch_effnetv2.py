"""EfficientNetV2 (``models/effnetv2.py``) and its weight bridge against the
reference: the port with bridged weights equals the flax model in f32
(rtol 1e-4, atol 1e-5, as tests/test_weights.py holds the flax model to
its torch mirror) at even and odd sizes; the folded graph equals the
unfolded one and the 1-channel stem the 3-channel one; bf16 stays within
a stated tolerance of the reference's bf16; the preprocessing equals the
reference's but for rounding ties and holds to the PIL oracle; the full
EFFNETV2_L carries timm's keys and shapes; a timm checkpoint file loads."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from saguaro_tpu.models.effnetv2 import EffNetV2 as RefEffNetV2
from saguaro_tpu.models.effnetv2 import EffNetV2Config as RefConfig
from saguaro_tpu.models.effnetv2 import StageSpec as RefStage
from saguaro_tpu.models.effnetv2 import fold_batchnorm as ref_fold_batchnorm
from saguaro_tpu.models.effnetv2 import fold_rgb_stem as ref_fold_rgb_stem
from saguaro_tpu.models.effnetv2 import preprocess_crops as ref_preprocess
from saguaro_tpu_torch.models import effnetv2 as pe
from saguaro_tpu_torch.models.weights import (
    effnet_name_map,
    effnet_state_dict_from_flax,
    load_effnet_checkpoint,
)

from .oracles import scale_to_8bit_oracle, timm_preprocess_oracle
from .test_torch_cellpose import randomize_bn
from .torch_data import TEffNetV2, share_cpu_threads

share_cpu_threads()

# tests/test_weights.py's TINY_EFFNET: fused blocks of expand 1 and 4, an
# MBConv with SE, three stride-2 convolutions
STAGES = (("fused", 1, 3, 1, 4, 2), ("fused", 4, 3, 2, 8, 2), ("mbconv", 4, 3, 2, 12, 2, 0.25))
REF_TINY = RefConfig(stem_filters=4, stages=tuple(RefStage(*s) for s in STAGES), head_filters=32,
                     input_size=32, compute_dtype="float32")
TINY = pe.EffNetV2Config(stem_filters=4, stages=tuple(pe.StageSpec(*s) for s in STAGES),
                         head_filters=32, input_size=32, compute_dtype="float32")


@pytest.fixture(scope="module")
def nets():
    """The reference's variables (BatchNorm statistics and affines made
    non-trivial) and the port's model on the bridged state dict."""
    variables = RefEffNetV2(REF_TINY).init(jax.random.PRNGKey(3), np.zeros((1, 32, 32, 3), np.float32))
    variables = randomize_bn(variables, 7)
    model = pe.EffNetV2(TINY).eval()
    model.load_state_dict(effnet_state_dict_from_flax(variables, TINY))
    return variables, model


def _ref_apply(cfg, variables, x_nhwc):
    with jax.default_matmul_precision("highest"):
        return np.asarray(RefEffNetV2(cfg).apply(variables, x_nhwc))


def _port_apply(model, x_nhwc):
    with torch.no_grad():
        return model(torch.from_numpy(np.moveaxis(x_nhwc, -1, 1).copy())).float().numpy()


@pytest.mark.parametrize("size", [32, 31, 26])
def test_bridged_weights_match_flax(nets, size):
    """Unfolded, 3-channel, f32: stride-2 SAME padding at even and odd sizes."""
    variables, model = nets
    x = np.random.default_rng(size).normal(size=(2, size, size, 3)).astype(np.float32)
    np.testing.assert_allclose(_port_apply(model, x), _ref_apply(REF_TINY, variables, x),
                               rtol=1e-4, atol=1e-5)


def test_same_padding_is_asymmetric_on_stride_two():
    assert pe.same_padding(32, 3, 2) == (0, 1)
    assert pe.same_padding(31, 3, 2) == (1, 1)
    assert pe.same_padding(32, 3, 1) == (1, 1)
    assert pe.same_padding(32, 1, 1) == (0, 0)


def test_fold_batchnorm_matches_unfolded_and_reference(nets):
    """The folded graph equals the unfolded one (f32), and the reference's
    folded graph; the BatchNorm keys leave the state dict."""
    variables, model = nets
    folded = pe.EffNetV2(TINY).eval()
    folded.load_state_dict(model.state_dict())
    pe.fold_batchnorm(folded)
    assert folded.config.fold_bn and not any("running_mean" in k for k in folded.state_dict())
    assert pe.fold_batchnorm(folded) is folded
    x = np.random.default_rng(1).normal(size=(2, 32, 32, 3)).astype(np.float32)
    want = _port_apply(model, x)
    np.testing.assert_allclose(_port_apply(folded, x), want, rtol=1e-4, atol=1e-5)
    ref_folded = ref_fold_batchnorm(variables)
    got_ref = _ref_apply(dataclasses.replace(REF_TINY, fold_bn=True), ref_folded, x)
    np.testing.assert_allclose(_port_apply(folded, x), got_ref, rtol=1e-4, atol=1e-5)


def test_fold_rgb_stem_matches_three_channels(nets):
    """fold_rgb_stem + one channel == three identical channels (f32), as the
    reference's fold; folding twice changes nothing."""
    variables, model = nets
    gray = np.random.default_rng(2).normal(size=(2, 32, 32, 1)).astype(np.float32)
    want = _port_apply(model, np.repeat(gray, 3, axis=-1))
    one = pe.EffNetV2(TINY).eval()
    one.load_state_dict(model.state_dict())
    pe.fold_rgb_stem(pe.fold_rgb_stem(one))
    assert one.conv_stem.weight.shape[1] == 1
    np.testing.assert_allclose(_port_apply(one, gray), want, rtol=1e-4, atol=1e-5)
    ref_one = ref_fold_rgb_stem(ref_fold_batchnorm(variables))
    got_ref = _ref_apply(dataclasses.replace(REF_TINY, fold_bn=True), ref_one, gray)
    np.testing.assert_allclose(_port_apply(pe.fold_batchnorm(one), gray), got_ref, rtol=1e-4, atol=1e-5)


def test_bf16_within_tolerance_of_reference_bf16(nets):
    """The folded graph in bf16 on both sides. The roundings happen at the
    same places (after every conv and bias, SE and pooling in f32), but the
    convolutions accumulate in another order, so one bf16 step (2**-8
    relative) can differ at any activation and carry through the 7 blocks:
    held to 3e-2 of the features' largest magnitude."""
    variables, model = nets
    bf_ref = dataclasses.replace(REF_TINY, compute_dtype="bfloat16", fold_bn=True)
    bf = pe.EffNetV2(dataclasses.replace(TINY, compute_dtype="bfloat16")).eval()
    bf.load_state_dict(model.state_dict())
    pe.fold_batchnorm(bf)
    x = np.random.default_rng(3).uniform(-1, 1, size=(4, 32, 32, 3)).astype(np.float32)
    want = _ref_apply(bf_ref, ref_fold_batchnorm(variables), x)
    got = _port_apply(bf, x)
    f32 = _port_apply(model, x)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 3e-2 * scale
    # and bf16 really rounds: it differs from f32
    assert np.abs(got - f32).max() > 0


@pytest.mark.parametrize("shape,out", [((3, 200, 200), 480), ((2, 40, 40), 64), ((2, 37, 51), 48)])
def test_preprocess_matches_reference_but_for_ties(shape, out):
    """Equal to the reference's preprocessing except at rounding ties of the
    uint8 steps, where it may be one step (2/255 after the normalisation)
    off; such pixels are rare."""
    rng = np.random.default_rng(sum(shape))
    crops = rng.uniform(0, 4000, shape).astype(np.float32)
    crops[0, : shape[1] // 3] = 0.0  # a masked-out band, as the crops have
    want = np.moveaxis(np.asarray(ref_preprocess(crops, out, n_channels=1)), -1, 1)
    got = pe.preprocess_crops(torch.from_numpy(crops), out, n_channels=1).numpy()
    assert got.shape == want.shape == (shape[0], 1, out, out)
    steps = np.abs(got - want) * 255.0 / 2.0
    assert steps.max() <= 1.0 + 1e-4
    assert (steps > 0.5).mean() < 1e-3


def test_preprocess_matches_pil_oracle():
    """The whole chain against the PIL pipeline: at most one uint8 level
    (rounding ties), tightly bounded mean."""
    crops = np.random.default_rng(0).uniform(0, 4000, (3, 200, 200)).astype(np.float32)
    got = pe.preprocess_crops(torch.from_numpy(crops), 480, n_channels=3).numpy()
    assert got.shape == (3, 3, 480, 480)
    for i in range(3):
        rgb = np.repeat(scale_to_8bit_oracle(crops[i])[..., None], 3, axis=-1)
        want = np.moveaxis(timm_preprocess_oracle(rgb, 480), -1, 0)
        diff_u8 = np.abs(got[i] - want) * 0.5 * 255.0
        assert diff_u8.max() <= 1.0 + 1e-3
        assert diff_u8.mean() < 0.01


def test_flat_crop_maps_to_minus_one():
    got = pe.preprocess_crops(torch.full((1, 64, 64), 7.0), 96, n_channels=1)
    assert torch.equal(got, torch.full((1, 1, 96, 96), -1.0))


def test_embed_crops_is_preprocess_then_network(nets):
    _, model = nets
    crops = torch.from_numpy(np.random.default_rng(5).uniform(0, 900, (2, 40, 40)).astype(np.float32))
    with torch.no_grad():
        want = model(pe.preprocess_crops(crops, 32, n_channels=3))
        assert torch.equal(pe.embed_crops(model, crops, 32), want)


def test_port_matches_timm_mirror_through_its_keys():
    """A timm-layout torch mirror's state dict drops into the port (strict)
    and both compute the same features: the keys mean the same tensors."""
    torch.manual_seed(0)
    mirror = TEffNetV2(TINY).eval()
    with torch.no_grad():
        for m in mirror.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.5, 0.5)
                m.running_var.uniform_(0.5, 2.0)
                m.weight.uniform_(0.5, 1.5)
    model = pe.EffNetV2(TINY).eval()
    model.load_state_dict(mirror.state_dict(), strict=True)
    x = torch.randn(2, 3, 33, 33)
    with torch.no_grad():
        torch.testing.assert_close(model(x), mirror(x), rtol=1e-4, atol=1e-5)


def test_full_l_keys_and_shapes_are_timm_s():
    """EFFNETV2_L, torch only (no flax init): the port's keys are
    ``effnet_name_map``'s timm keys, with the timm mirror's shapes, and the
    mirror's state dict loads strictly."""
    with torch.device("meta"):
        port = pe.EffNetV2(pe.EFFNETV2_L)
        mirror = TEffNetV2(pe.EFFNETV2_L)
    sd = port.state_dict()
    keys = {k for k in sd if not k.endswith("num_batches_tracked")}
    assert keys == set(effnet_name_map(pe.EFFNETV2_L).values())
    want = mirror.state_dict()
    assert sd.keys() == want.keys()
    assert all(sd[k].shape == want[k].shape for k in sd)
    port.load_state_dict(want, strict=True, assign=True)


def test_checkpoint_file_loads(tmp_path):
    """A transformers-style file (``state_dict`` wrapper, ``timm_model.``
    prefix, a classifier) loads into the port; a file in the JAX package's
    own checkpoint format is no torch file, and the torch loader says where
    such a file is read (``models.checkpoint.load_variables``, held in
    test_torch_checkpoint)."""
    torch.manual_seed(1)
    mirror = TEffNetV2(TINY).eval()
    blob = {f"timm_model.{k}": v for k, v in mirror.state_dict().items()}
    blob["timm_model.classifier.weight"] = torch.zeros(10, 32)
    path = tmp_path / "effnet.pth"
    torch.save({"state_dict": blob}, path)
    model = pe.EffNetV2(TINY).eval()
    model.load_state_dict(load_effnet_checkpoint(str(path)), strict=True)
    x = torch.randn(1, 3, 32, 32)
    with torch.no_grad():
        torch.testing.assert_close(model(x), mirror(x), rtol=1e-4, atol=1e-5)
    flax_file = tmp_path / "effnet.msgpack"
    flax_file.write_bytes(b"SGTPU1\n" + bytes(16))
    with pytest.raises(ValueError, match="not a torch file.*load_variables"):
        load_effnet_checkpoint(str(flax_file))


def test_init_is_seeded_and_on_the_named_device():
    a = pe.init_effnetv2(TINY, seed=4, device="cpu")
    b = pe.init_effnetv2(TINY, seed=4, device="cpu")
    c = pe.init_effnetv2(TINY, seed=5, device="cpu")
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["conv_stem.weight"], sc["conv_stem.weight"])
    assert not a.training and sa["conv_stem.weight"].device.type == "cpu"
