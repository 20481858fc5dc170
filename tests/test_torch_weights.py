"""The weight modules (``models/weights.py``, ``models/cellpose_weights.py``,
``models/effnet_weights.py``) against the reference's, on synthetic state
dicts: the layout converters and their inverses, ``flatten_tree`` and
``unflatten_tree``, ``convert_state_dict`` and ``convert_by_order`` equal
the reference's outputs exactly; the name maps equal the reference's; each
network's converter and torch-file loader unwraps ``torch.save`` files
(bare, under ``state_dict``/``model``, with wrappers' key prefixes) into
the state dict the network loads, which the reference's loader turns into
the same weights; a file that is not a torch save raises."""

import jax
import numpy as np
import pytest
import torch

from saguaro_tpu.models import cellpose_weights as ref_cpw
from saguaro_tpu.models import effnet_weights as ref_enw
from saguaro_tpu.models import weights as ref_w
from saguaro_tpu.models.cellpose import CellposeConfig as RefCellposeConfig
from saguaro_tpu.models.cellpose import init_cellpose as ref_init_cellpose
from saguaro_tpu.models.effnetv2 import EFFNETV2_L as REF_L
from saguaro_tpu.models.effnetv2 import EffNetV2Config as RefEffConfig
from saguaro_tpu.models.effnetv2 import StageSpec as RefStage
from saguaro_tpu.models.effnetv2 import init_effnetv2 as ref_init_effnetv2
from saguaro_tpu_torch.models import cellpose_weights, effnet_weights, weights
from saguaro_tpu_torch.models.cellpose import CellposeConfig, CellposeUNet
from saguaro_tpu_torch.models.effnetv2 import EFFNETV2_L, EffNetV2, EffNetV2Config, StageSpec

from .torch_data import share_cpu_threads

share_cpu_threads()

FEATURES = (4, 8, 16, 32)
STAGES = (("fused", 1, 3, 1, 4, 2), ("fused", 4, 3, 2, 8, 2), ("mbconv", 4, 3, 2, 12, 2, 0.25))
REF_TINY = RefEffConfig(stem_filters=4, stages=tuple(RefStage(*s) for s in STAGES), head_filters=16,
                        input_size=32)
TINY = EffNetV2Config(stem_filters=4, stages=tuple(StageSpec(*s) for s in STAGES), head_filters=16,
                      input_size=32)


def _random_numpy_state_dict(model: torch.nn.Module, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {k: (rng.uniform(0.5, 1.5, v.shape) if "running_var" in k else rng.normal(0, 1, v.shape))
            .astype(np.float32) if v.is_floating_point() else v.numpy()
            for k, v in model.state_dict().items()}


def _assert_trees_equal(got: dict, want: dict) -> None:
    got, want = ref_w.flatten_tree(got), ref_w.flatten_tree(want)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def cellpose_case():
    cfg = CellposeConfig(tile=32, features=FEATURES)
    ref_cfg = RefCellposeConfig(tile=32, features=FEATURES)
    _, template = ref_init_cellpose(ref_cfg, seed=0)
    net = CellposeUNet(cfg).eval()
    return cfg, ref_cfg, jax.tree.map(np.asarray, template), net, _random_numpy_state_dict(net, 1)


@pytest.fixture(scope="module")
def effnet_case():
    _, template = ref_init_effnetv2(REF_TINY, seed=0, init_size=32)
    net = EffNetV2(TINY).eval()
    return jax.tree.map(np.asarray, template), net, _random_numpy_state_dict(net, 2)


@pytest.mark.parametrize("name,shape", [("conv_torch_to_flax", (5, 3, 3, 3)),
                                        ("depthwise_torch_to_flax", (6, 1, 3, 3)),
                                        ("linear_torch_to_flax", (7, 4)),
                                        ("linear_torch_to_flax", (6, 6))])
def test_layouts_match_reference_and_invert(name, shape):
    w = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    got = getattr(weights, name)(w)
    np.testing.assert_array_equal(got, getattr(ref_w, name)(w))
    t = torch.from_numpy(w)
    torch.testing.assert_close(weights.torch_to_flax_layout(t), torch.from_numpy(np.ascontiguousarray(got)),
                               rtol=0, atol=0)
    torch.testing.assert_close(weights.flax_to_torch_layout(weights.torch_to_flax_layout(t)), t,
                               rtol=0, atol=0)


def test_flatten_unflatten_match_reference(cellpose_case):
    *_, template, _, _ = cellpose_case
    flat = weights.flatten_tree(template)
    want = ref_w.flatten_tree(template)
    assert list(flat) == list(want)
    _assert_trees_equal(weights.unflatten_tree(flat), ref_w.unflatten_tree(want))


def test_name_maps_equal_reference():
    for f in ((8, 16, 32, 64), (32, 64, 128, 256)):
        assert cellpose_weights.cellpose_name_map(CellposeConfig(features=f)) == \
            ref_cpw.cellpose_name_map(RefCellposeConfig(features=f))
    assert effnet_weights.effnet_name_map(TINY) == ref_enw.effnet_name_map(REF_TINY)
    assert effnet_weights.effnet_name_map(EFFNETV2_L) == ref_enw.effnet_name_map(REF_L)


def test_convert_state_dict_matches_reference(cellpose_case):
    cfg, ref_cfg, template, _, sd = cellpose_case
    name_map = cellpose_weights.cellpose_name_map(cfg)
    transforms = {k: weights.linear_torch_to_flax for k in name_map if k.endswith("full/kernel")}
    got = weights.convert_state_dict(sd, template, name_map, transforms)
    _assert_trees_equal(got, ref_w.convert_state_dict(sd, template, name_map, transforms))
    _assert_trees_equal(got, ref_cpw.convert_cellpose_state_dict(sd, template, ref_cfg))


def test_convert_state_dict_rank_default_and_shape_check(effnet_case):
    template, _, sd = effnet_case
    name_map = effnet_weights.effnet_name_map(TINY)
    _assert_trees_equal(weights.convert_state_dict(sd, template, name_map),
                        ref_w.convert_state_dict(sd, template, name_map))
    bad = dict(sd, **{"conv_stem.weight": np.zeros((4, 3, 5, 5), np.float32)})
    with pytest.raises(ValueError, match="_ConvBNAct_0/Conv_0/kernel"):
        weights.convert_state_dict(bad, template, name_map)


@pytest.mark.parametrize("case", ["cellpose", "effnet"])
def test_convert_by_order_matches_reference(case, cellpose_case, effnet_case):
    if case == "cellpose":
        *_, template, _, sd = cellpose_case
    else:
        template, _, sd = effnet_case
    skip = lambda k: k.endswith("num_batches_tracked")  # noqa: E731
    got, report = weights.convert_by_order(sd, template, skip)
    want, want_report = ref_w.convert_by_order(sd, template, skip)
    assert report == want_report
    _assert_trees_equal(got, want)


def test_flax_bridge_inverts_the_conversion(cellpose_case):
    """convert (torch -> flax) then the bridge (flax -> torch) gives the
    state dict back, the square style kernels of the last stage included."""
    cfg, ref_cfg, template, _, sd = cellpose_case
    tree = ref_cpw.convert_cellpose_state_dict(sd, template, ref_cfg)
    back = cellpose_weights.cellpose_state_dict_from_flax(tree, cfg)
    assert back["upsample.up.res_up_3.conv.conv_1.full.weight"].shape == (32, 32)
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)


def _save(obj, path) -> str:
    torch.save(obj, path)
    return str(path)


@pytest.mark.parametrize("wrap", ["bare", "state_dict", "model", "module."])
def test_cellpose_file_loads_into_the_network(cellpose_case, tmp_path, wrap):
    cfg, ref_cfg, template, net, sd = cellpose_case
    tensors = {k: torch.from_numpy(v.copy()) for k, v in sd.items()}
    stored = dict(tensors, diam_mean=torch.tensor(17.0), diam_labels=torch.tensor(16.5))
    if wrap == "module.":
        stored = {f"module.{k}": v for k, v in stored.items()}
    elif wrap != "bare":
        stored = {wrap: stored}
    path = _save(stored, tmp_path / "cpnet.pt")
    got = cellpose_weights.load_torch_cellpose(path)
    assert set(got) == set(tensors)
    for k, v in tensors.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)
    net.load_state_dict(got, strict=True)
    if wrap == "module.":
        return  # the reference's cellpose loader strips no prefix
    want = ref_cpw.load_torch_cellpose(path, template, ref_cfg)
    for k, v in cellpose_weights.cellpose_state_dict_from_flax(want, cfg).items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)


@pytest.mark.parametrize("prefix", ["", "timm_model.", "model."])
def test_effnet_file_loads_into_the_network(effnet_case, tmp_path, prefix):
    template, net, sd = effnet_case
    tensors = {k: torch.from_numpy(v.copy()) for k, v in sd.items()}
    stored = dict(tensors, **{"classifier.weight": torch.zeros(10, 16), "classifier.bias": torch.zeros(10)})
    path = _save({f"{prefix}{k}": v for k, v in stored.items()}, tmp_path / "effnet.pth")
    got = effnet_weights.load_torch_effnet(path)
    assert set(got) == set(tensors)
    net.load_state_dict(got, strict=True)
    want = ref_enw.load_torch_effnet(path, template, REF_TINY)
    for k, v in effnet_weights.effnet_state_dict_from_flax(want, TINY).items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)


def test_converters_take_numpy_state_dicts(cellpose_case, effnet_case):
    *_, sd = cellpose_case
    got = cellpose_weights.convert_cellpose_state_dict(dict(sd, diam_mean=np.float32(30.0)))
    assert set(got) == set(sd) and all(isinstance(v, torch.Tensor) for v in got.values())
    *_, sd = effnet_case
    got = effnet_weights.convert_effnet_state_dict({f"timm_model.{k}": v for k, v in sd.items()})
    assert set(got) == set(sd)


@pytest.mark.parametrize("blob", [b"not a torch file", b"SGTPU1\n" + bytes(16), b""])
def test_not_a_torch_file_raises(tmp_path, blob):
    path = tmp_path / "x.bin"
    path.write_bytes(blob)
    with pytest.raises(ValueError, match="not a torch file"):
        weights.read_torch_state_dict(str(path))


def test_a_torch_file_without_a_state_dict_raises(tmp_path):
    with pytest.raises(ValueError, match="not a state dict"):
        weights.read_torch_state_dict(_save([torch.zeros(2)], tmp_path / "list.pt"))


@pytest.mark.parametrize("name,module,there", [
    ("cellpose_name_map", cellpose_weights, "cellpose_name_map"),
    ("cellpose_state_dict_from_flax", cellpose_weights, "cellpose_state_dict_from_flax"),
    ("load_cellpose_checkpoint", cellpose_weights, "load_torch_cellpose"),
    ("effnet_name_map", effnet_weights, "effnet_name_map"),
    ("effnet_state_dict_from_flax", effnet_weights, "effnet_state_dict_from_flax"),
    ("load_effnet_checkpoint", effnet_weights, "load_torch_effnet"),
])
def test_moved_names_stay_importable_from_weights(name, module, there):
    assert getattr(weights, name) is getattr(module, there)
    with pytest.raises(AttributeError):
        weights.no_such_name  # noqa: B018
