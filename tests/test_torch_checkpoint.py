"""Checkpoints (``models/checkpoint.py``) between the two packages, on the
CPU: a file the port writes is read by the JAX package's
``load_variables`` and one the JAX package writes is read by the port, for
CellposeUNet and an unfolded EfficientNetV2-S, every array equal; a wrong
magic number, a missing weight, a wrong shape and folded EfficientNet
variables raise; the msgpack codec's output decodes with ``msgpack`` and
decodes what ``msgpack`` writes; and the port's ``train_segmenter`` writes
a file that both packages' engines load, giving the same flows on a tile
(f32, 1e-4 of their scale, as tests/test_torch_cellpose holds the nets)."""

import os

import jax
import msgpack
import numpy as np
import pytest
import torch

from saguaro_tpu.models import checkpoint as ref_ckpt
from saguaro_tpu.models.cellpose import CellposeConfig as RefCellposeConfig
from saguaro_tpu.models.cellpose import init_cellpose as ref_init_cellpose
from saguaro_tpu.models.cellpose_weights import convert_cellpose_state_dict as ref_convert_cellpose
from saguaro_tpu.models.effnet_weights import convert_effnet_state_dict as ref_convert_effnet
from saguaro_tpu.models.effnetv2 import EFFNETV2_S as REF_S
from saguaro_tpu.models.effnetv2 import fold_batchnorm as ref_fold_batchnorm
from saguaro_tpu.models.effnetv2 import init_effnetv2 as ref_init_effnetv2
from saguaro_tpu.models.weights import flatten_tree
from saguaro_tpu_torch.models import checkpoint
from saguaro_tpu_torch.models.cellpose import CellposeConfig, CellposeUNet
from saguaro_tpu_torch.models.cellpose_weights import cellpose_state_dict_from_flax
from saguaro_tpu_torch.models.effnet_weights import effnet_state_dict_from_flax
from saguaro_tpu_torch.models.effnetv2 import EFFNETV2_S, EffNetV2

from .test_torch_cellpose import randomize_bn
from .torch_data import share_cpu_threads

share_cpu_threads()

FEATURES = (4, 8, 16, 32)


def _random_state_dict(model: torch.nn.Module, seed: int) -> dict:
    """Every weight and BatchNorm statistic of ``model`` drawn at random."""
    gen = torch.Generator().manual_seed(seed)
    sd = model.state_dict()
    for k, v in sd.items():
        if v.is_floating_point():
            v.copy_(torch.rand(v.shape, generator=gen) + (0.5 if "running_var" in k else -0.5))
    return sd


def _assert_trees_equal(got: dict, want: dict) -> None:
    got, want = flatten_tree(got), flatten_tree(want)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _assert_state_dicts_equal(got: dict, want: dict) -> None:
    want = {k: v for k, v in want.items() if not k.endswith("num_batches_tracked")}
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)


@pytest.fixture(scope="module")
def cellpose_pair():
    cfg = CellposeConfig(tile=32, features=FEATURES)
    _, template = ref_init_cellpose(RefCellposeConfig(tile=32, features=FEATURES), seed=0)
    return cfg, CellposeUNet(cfg).eval(), jax.tree.map(np.asarray, template)


@pytest.fixture(scope="module")
def effnet_pair():
    _, template = ref_init_effnetv2(REF_S, seed=0)
    return EffNetV2(EFFNETV2_S).eval(), jax.tree.map(np.asarray, template)


def test_cellpose_port_writes_reference_reads(cellpose_pair, tmp_path):
    cfg, net, template = cellpose_pair
    sd = _random_state_dict(net, 3)
    path = str(tmp_path / "cp.ckpt")
    checkpoint.save_variables(path, net, cfg)
    got, header = ref_ckpt.load_variables(path, template)
    assert header["config_class"] == "CellposeConfig" and header["config"]["tile"] == 32
    want = ref_convert_cellpose({k: v.numpy() for k, v in sd.items()}, template,
                                RefCellposeConfig(tile=32, features=FEATURES))
    _assert_trees_equal(jax.tree.map(np.asarray, got), want)


def test_cellpose_reference_writes_port_reads(cellpose_pair, tmp_path):
    cfg, net, template = cellpose_pair
    variables = randomize_bn(template, 4)
    variables = jax.tree.map(lambda a: a + np.float32(0.25), variables)
    path = str(tmp_path / "cp.ckpt")
    ref_ckpt.save_variables(path, variables, RefCellposeConfig(tile=32, features=FEATURES))
    got, header = checkpoint.load_variables(path, net)
    assert header["config"]["features"] == list(FEATURES)
    _assert_state_dicts_equal(got, cellpose_state_dict_from_flax(variables, cfg))
    net.load_state_dict(got)


def test_effnet_port_writes_reference_reads(effnet_pair, tmp_path):
    net, template = effnet_pair
    sd = _random_state_dict(net, 5)
    path = str(tmp_path / "en.ckpt")
    checkpoint.save_variables(path, net)
    got, header = ref_ckpt.load_variables(path, template)
    assert header == {}
    _assert_trees_equal(jax.tree.map(np.asarray, got),
                        ref_convert_effnet({k: v.numpy() for k, v in sd.items()}, template, REF_S))


def test_effnet_reference_writes_port_reads(effnet_pair, tmp_path):
    net, template = effnet_pair
    variables = randomize_bn(template, 6)
    path = str(tmp_path / "en.ckpt")
    ref_ckpt.save_variables(path, variables)
    got, _ = checkpoint.load_variables(path, net)
    _assert_state_dicts_equal(got, effnet_state_dict_from_flax(variables, EFFNETV2_S))


def test_folded_effnet_variables_raise_naming_them(effnet_pair, tmp_path):
    net, template = effnet_pair
    path = str(tmp_path / "folded.ckpt")
    ref_ckpt.save_variables(path, jax.tree.map(np.asarray, ref_fold_batchnorm(template)))
    with pytest.raises(ValueError, match="folded EfficientNet.*_ConvBNAct_0/Conv_0/bias"):
        checkpoint.load_variables(path, net)


def test_bad_magic_raises(tmp_path):
    """The counterpart of tests/test_checkpoint.py's test_bad_magic_raises."""
    path = str(tmp_path / "junk.bin")
    with open(path, "wb") as f:
        f.write(b"not a checkpoint")
    with pytest.raises(ValueError, match="not a saguaro_tpu checkpoint"):
        checkpoint.load_variables(path, CellposeUNet(CellposeConfig(features=FEATURES)))


def test_missing_weight_raises(cellpose_pair, tmp_path):
    cfg, net, template = cellpose_pair
    variables = {"params": dict(template["params"]), "batch_stats": template["batch_stats"]}
    del variables["params"]["res_up_2"]
    path = str(tmp_path / "cp.ckpt")
    ref_ckpt.save_variables(path, variables)
    with pytest.raises(ValueError, match="lacks .*params/res_up_2/"):
        checkpoint.load_variables(path, net)


def test_wrong_shape_raises(cellpose_pair, tmp_path):
    cfg, net, template = cellpose_pair
    path = str(tmp_path / "cp.ckpt")
    ref_ckpt.save_variables(path, template)
    wider = CellposeUNet(CellposeConfig(tile=32, features=(4, 8, 16, 64))).eval()
    with pytest.raises(ValueError, match="wrong shape.*res_down_3"):
        checkpoint.load_variables(path, wider)


def test_bf16_leaves_read_as_the_template_dtype(cellpose_pair, tmp_path):
    cfg, net, template = cellpose_pair
    sd = {k: v.to(torch.bfloat16) if v.is_floating_point() else v for k, v in net.state_dict().items()}
    path = str(tmp_path / "bf16.ckpt")
    checkpoint.save_variables(path, sd, cfg)
    got, _ = checkpoint.load_variables(path, net)
    leaves = flatten_tree(jax.tree.map(np.asarray, ref_ckpt.load_variables(path, template)[0]))
    assert {str(v.dtype) for v in leaves.values()} == {"bfloat16"}
    for k, v in got.items():
        assert v.dtype == torch.float32
        torch.testing.assert_close(v, sd[k].float(), rtol=0, atol=0)


VALUES = {
    "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32, 2**63 - 1, -1, -32, -33, -129, -2**40],
    "floats": [0.0, -1.5, 1e300, 3.25e-7],
    "strings": ["", "a", "x" * 31, "y" * 32, "é" * 40, "z" * 70000],
    "bytes": [b"", b"\x00\xff", bytes(300), bytes(70000)],
    "flags": [True, False, None],
    "long list": list(range(20)),
    "nested": {str(i): {"k": [i, str(i)]} for i in range(18)},
}


def test_codec_output_decodes_with_msgpack():
    got = msgpack.unpackb(checkpoint.packb(VALUES), raw=False, strict_map_key=False)
    assert got == VALUES


@pytest.mark.parametrize("use_single_float", [False, True])
def test_codec_decodes_msgpack_output(use_single_float):
    values = dict(VALUES, floats=[0.0, -1.5, 3.25] + ([] if use_single_float else [1e300, 3.25e-7]))
    data = msgpack.packb(values, use_bin_type=True, use_single_float=use_single_float)
    assert checkpoint.unpackb(data) == values


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32, torch.uint8, torch.float64])
def test_tensor_leaves_decode_as_flax_arrays(dtype):
    """A leaf is flax's ndarray extension: msgpack's ExtType(1, ...) whose
    payload unpacks to (shape, dtype name, bytes); numpy scalars (flax's
    type 3) and empty arrays read back too."""
    t = (torch.arange(12) * 3).reshape(3, 4).to(dtype)
    ext = msgpack.unpackb(checkpoint.packb({"a": t}), raw=False)["a"]
    assert isinstance(ext, msgpack.ExtType) and ext.code == 1
    shape, name, raw = msgpack.unpackb(ext.data, raw=False)
    assert shape == [3, 4] and name == str(dtype).split(".")[1] and len(raw) == t.numel() * t.element_size()
    torch.testing.assert_close(checkpoint.unpackb(checkpoint.packb({"a": t}))["a"], t, rtol=0, atol=0)
    scalar = msgpack.packb(msgpack.ExtType(3, msgpack.packb(((), "int32", np.int32(7).tobytes()),
                                                          use_bin_type=True)))
    assert checkpoint.unpackb(scalar).item() == 7
    empty = checkpoint.unpackb(checkpoint.packb(torch.zeros((0, 5), dtype=dtype)))
    assert empty.shape == (0, 5) and empty.dtype == dtype


def test_train_segmenter_checkpoint_loads_in_both_engines(tmp_path):
    """The counterpart of tests/test_checkpoint.py's test_train_from_tiff_pairs:
    the port's CLI trains on 4 TIFF pairs and writes a checkpoint; both
    engines load it (f32 convolutions) and their CPnets give the same flows
    and cellprob on a tile."""
    from saguaro_tpu.models.cellpose import CellposeUNet as RefUNet
    from saguaro_tpu.models.effnetv2 import EffNetV2Config as RefEffConfig
    from saguaro_tpu.models.effnetv2 import StageSpec as RefStage
    from saguaro_tpu.pipeline.segment_embed import SegmentEmbedConfig as RefEngineConfig
    from saguaro_tpu.pipeline.segment_embed import SegmentEmbedEngine as RefEngine
    from saguaro_tpu_torch.cli.train_segmenter import main
    from saguaro_tpu_torch.io import tiff
    from saguaro_tpu_torch.models.cellpose_train import synthetic_nuclei
    from saguaro_tpu_torch.models.effnetv2 import EffNetV2Config, StageSpec
    from saguaro_tpu_torch.pipeline.segment_embed import SegmentEmbedConfig, SegmentEmbedEngine

    rng = np.random.default_rng(0)
    data = tmp_path / "train"
    data.mkdir()
    for i in range(4):
        img, labels = synthetic_nuclei(rng, size=64, n_cells=3)
        tiff.imwrite(str(data / f"img{i}.tiff"), (img[..., 0] * 1000).astype(np.uint16))
        tiff.imwrite(str(data / f"img{i}_masks.tiff"), labels.astype(np.uint16))
    out = str(tmp_path / "model.ckpt")
    result, timer = main(["--data_dir", str(data), "--output", out, "--steps", "5", "--batch_size", "2",
                          "--tile", "64", "--device", "cpu"])
    assert os.path.exists(out) and len(result.losses) == 5
    assert set(timer.total) == {"read", "flows", "train", "save"}

    tiny = dict(stem_filters=4, stages=(("fused", 1, 3, 1, 4, 1),), head_filters=8, input_size=32)
    port = SegmentEmbedEngine(SegmentEmbedConfig(
        channels=["DNA"], cellpose_checkpoint=out,
        cellpose=CellposeConfig(tile=64, compute_dtype="float32"),
        effnet=EffNetV2Config(**{**tiny, "stages": tuple(StageSpec(*s) for s in tiny["stages"])})),
        device="cpu")
    ref = RefEngine(RefEngineConfig(
        channels=["DNA"], cellpose_checkpoint=out,
        cellpose=RefCellposeConfig(tile=64, compute_dtype="float32"),
        effnet=RefEffConfig(**{**tiny, "stages": tuple(RefStage(*s) for s in tiny["stages"])})))
    _assert_state_dicts_equal(
        {k: v.cpu() for k, v in port.cell_model.state_dict().items() if not k.endswith("num_batches_tracked")},
        cellpose_state_dict_from_flax(jax.tree.map(np.asarray, ref.cell_vars), port.cfg.cellpose))
    torch.testing.assert_close({k: v.cpu() for k, v in port.cell_model.state_dict().items()
                                if not k.endswith("num_batches_tracked")},
                               {k: v.cpu() for k, v in result.variables.items()
                                if not k.endswith("num_batches_tracked")}, rtol=0, atol=0)
    img, _ = synthetic_nuclei(rng, size=64, n_cells=3)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(RefUNet(ref.cfg.cellpose).apply)(ref.cell_vars, img[None]))
    with torch.no_grad():
        got = port.cell_model(torch.from_numpy(img[None])).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_engine_loads_an_effnet_checkpoint(tmp_path):
    """``effnet_checkpoint=`` takes the package's format too: the engine's
    (unfolded) EfficientNet holds the written weights."""
    from saguaro_tpu_torch.models.effnetv2 import EffNetV2Config, StageSpec
    from saguaro_tpu_torch.pipeline.segment_embed import SegmentEmbedConfig, SegmentEmbedEngine

    tiny = EffNetV2Config(stem_filters=4, stages=(StageSpec("mbconv", 4, 3, 2, 8, 1, 0.25),),
                          head_filters=8, input_size=32)
    net = EffNetV2(tiny).eval()
    sd = _random_state_dict(net, 8)
    path = str(tmp_path / "en.ckpt")
    checkpoint.save_variables(path, net, tiny)
    engine = SegmentEmbedEngine(SegmentEmbedConfig(
        channels=["DNA"], effnet_checkpoint=path, effnet=tiny, fold_bn=False, fold_rgb_stem=False,
        cellpose=CellposeConfig(features=FEATURES)), device="cpu")
    _assert_state_dicts_equal({k: v for k, v in engine.feat_model.state_dict().items()
                               if not k.endswith("num_batches_tracked")}, sd)


def test_engine_refuses_a_file_in_neither_format(tmp_path):
    from saguaro_tpu_torch.pipeline.segment_embed import SegmentEmbedConfig, SegmentEmbedEngine

    path = str(tmp_path / "neither.bin")
    with open(path, "wb") as f:
        f.write(b"\x00" * 64)
    with pytest.raises(ValueError, match="not a torch file"):
        SegmentEmbedEngine(SegmentEmbedConfig(channels=["DNA"], cellpose_checkpoint=path,
                                              cellpose=CellposeConfig(features=FEATURES)), device="cpu")
