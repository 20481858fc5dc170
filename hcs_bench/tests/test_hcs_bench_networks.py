"""The network plug-ins (``networks/``): each network's FLOPs against shapes
worked by hand, its state dict's layout, its forward passes for the
reference and the control, and the program's config classes built from a
configuration's sections by dotted path. The reference's tiling of a field
larger than one tile, which a segmenter's forward pass goes through."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from hcs_bench import networks, program
from hcs_bench import yardstick as ys
from hcs_bench.networks import cpnet, effnetv2
from hcs_bench.reference import cellpose_ref

BENCH = Path(__file__).resolve().parents[1]
CONFIGS = {p.stem: json.loads(p.read_text()) for p in sorted((BENCH / "configs").glob("*.json"))}


def block(cin, cout, side):
    """proj 1x1, conv_0 3x3, conv_1..3 3x3, 2 FLOPs a multiply-add"""
    return 2 * side * side * (cin * cout + cin * cout * 9 + 3 * cout * cout * 9)


def test_cpnet_tiny_by_hand():
    # down 1->2 at 4x4: 2*16*(2 + 18 + 108) = 4096; up 2->2 at 4x4:
    # 2*16*(4 + 36 + 108) = 4736; head 1x1 2->3: 2*16*6 = 192
    assert cpnet.cpnet_conv_flops((2,), 1, 4) == 4096 + 4736 + 192


def test_cpnet_published_widths():
    want = (block(2, 32, 224) + block(32, 64, 112) + block(64, 128, 56) + block(128, 256, 28)
            + block(64, 32, 224) + block(128, 64, 112) + block(256, 128, 56) + block(256, 256, 28)
            + 2 * 224 * 224 * 32 * 3)
    assert cpnet.cpnet_conv_flops((32, 64, 128, 256), 2, 224) == want


def test_cpnet_site_tiles():
    cp = {"features": [32, 64, 128, 256], "n_channels": 2, "diam_mean": 30.0, "tile": 224,
          "tile_overlap": 0.1}
    # 1080 * 30 / 100 = 324: tiles at 0 and 100 on each axis
    assert ys.tile_starts(324, 224, 0.1) == [0, 100]
    assert cpnet.cpnet_site_flops(cp, 100.0, 1080, 1080) == 4 * cpnet.cpnet_conv_flops((32, 64, 128, 256), 2, 224)
    assert ys.tile_starts(200, 224, 0.1) == [0]
    # the nuclei model's diam_mean 17: 1080 * 17 / 100 = 184, one tile
    nuclei = dict(cp, diam_mean=17.0)
    assert cpnet.cpnet_site_flops(nuclei, 100.0, 1080, 1080) == cpnet.cpnet_conv_flops((32, 64, 128, 256), 2, 224)


def test_effnet_tiny_by_hand():
    ef = {"stem_filters": 8, "head_filters": 32,
          "stages": [["fused", 1, 3, 1, 8, 1, 0.0], ["mbconv", 2, 3, 2, 16, 1, 0.25]]}
    # stem 1->8 3x3/2 at 4x4: 1152; fused 8->8 3x3: 9216; expand 8->16 1x1:
    # 2048; depthwise 16 3x3/2 at 2x2: 576; SE 2*16*2: 64; project 16->16
    # at 2x2: 1024; head 16->32 at 2x2: 2048
    macs, n_bytes = effnetv2.effnet_cost(ef, 8, in_ch=1)
    assert macs == 1152 + 9216 + 2048 + 576 + 64 + 1024 + 2048
    assert n_bytes == 4 * (128 + 128 + 256 + 64 + 64 + 128) + 4 * 64


def test_effnetv2_l_at_480():
    cfg = CONFIGS["cellpose_nuclei.effnetv2_l"]
    macs, _ = effnetv2.effnet_cost(cfg["effnet"], 480, in_ch=3)
    # timm lists tf_efficientnetv2_l at 480 as 56.4 GMACs
    assert 55e9 < macs < 57e9


def test_cpnet_state_has_cellpose_keys_at_the_published_widths():
    sd = cpnet.cpnet_state({"n_channels": 2, "features": [32, 64, 128, 256]}, "cpu")
    assert sd["downsample.down.res_down_0.proj.1.weight"].shape == (32, 2, 1, 1)
    assert sd["upsample.up.res_up_3.conv.conv_1.full.weight"].shape == (256, 256)
    assert sd["output.2.weight"].shape == (3, 32, 1, 1)


def test_each_role_counts_its_unit():
    cfg = CONFIGS["cellpose_nuclei.effnetv2_l"]
    traffic = {"size": 1080}
    assert [(role, net) for role, net in networks.named(cfg)] == [("segmenter", cpnet), ("embedder", effnetv2)]
    assert cpnet.flops(cfg, traffic) == cpnet.cpnet_site_flops(cfg["cellpose"], 100.0, 1080, 1080)
    assert effnetv2.flops(cfg, traffic) == 2.0 * effnetv2.effnet_cost(cfg["effnet"], 480, in_ch=3)[0]


def small_cpnet(seed=3):
    cp = {"n_channels": 2, "features": [4, 8], "diam_mean": 17.0, "tile": 32, "tile_overlap": 0.1}
    sd = cpnet.cpnet_state(cp, "cpu")
    gen = torch.Generator().manual_seed(seed)
    for k, v in sd.items():
        if k.endswith(".weight") and v.dim() >= 2:
            v.copy_(torch.randn(v.shape, generator=gen) / v[0].numel() ** 0.5)
    return {"cellpose": cp}, sd


def test_cpnet_forward_and_its_control():
    cfg, sd = small_cpnet()
    x = torch.rand(2, 2, 32, 32, generator=torch.Generator().manual_seed(1))
    ref = cpnet.forward(cfg, sd, "cpu")(x)
    low = cpnet.forward(cfg, sd, "cpu", lower=True)(x)
    assert ref.shape == low.shape == (2, 3, 32, 32) and ref.dtype == torch.float32
    assert torch.equal(ref, cpnet.cpnet(x, sd, 2))
    gap = (low.float() - ref).abs().max() / ref.abs().max()
    assert 0 < gap < 0.5


def test_effnetv2_forward_and_its_control():
    ef = {"stem_filters": 8, "head_filters": 16, "input_size": 16, "compute_dtype": "bfloat16",
          "stages": [["fused", 1, 3, 1, 8, 1, 0.0], ["mbconv", 2, 3, 2, 16, 1, 0.25]]}
    cfg = {"effnet": ef, "engine": {"embed_size": 16}}
    torch.manual_seed(0)
    state = effnetv2.EffNetV2(effnetv2.effnet_config(cfg, "float32")).state_dict()
    crops = torch.rand(3, 20, 20, generator=torch.Generator().manual_seed(2)) * 1000
    ref = effnetv2.forward(cfg, state, "cpu")(crops)
    low = effnetv2.forward(cfg, state, "cpu", lower=True)(crops)
    assert ref.shape == low.shape == (3, 16) and not torch.equal(ref, low.float())


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_classes_built_by_dotted_path(name):
    """Each section that names a class builds the program's config as it
    was built field by field: lists as tuples, stage rows as StageSpecs."""
    cfg = CONFIGS[name]
    cp = {k: v for k, v in cfg["cellpose"].items() if k != "class"}
    cellpose_config = program.resolve(cfg["cellpose"]["class"])
    assert program.build_config(cfg["cellpose"]) == cellpose_config(**dict(cp, features=tuple(cp["features"])))
    if "effnet" in cfg:
        e = cfg["effnet"]
        effnet_config = program.resolve(e["class"])
        stage = program.resolve(e["class"].rpartition(".")[0] + ".StageSpec")
        assert program.build_config(e) == effnet_config(
            stem_filters=e["stem_filters"], head_filters=e["head_filters"], input_size=e["input_size"],
            compute_dtype=e["compute_dtype"], stages=tuple(stage(*s) for s in e["stages"]))


def test_build_refuses_what_is_not_the_program_or_an_engine_field():
    with pytest.raises(ValueError):
        program.resolve("hcs_bench.program.Window")
    cfg = dict(CONFIGS["cellpose_nuclei.cellprofiler_cl2"])
    cfg["engine"] = dict(cfg["engine"], no_such_field=1)
    with pytest.raises(ValueError, match="no_such_field"):
        program.build_engine(cfg, {}, "cpu")


def test_one_tile_goes_through_as_it_is():
    calls = []

    def forward(x):
        calls.append(tuple(x.shape))
        return x[:, :1].repeat(1, 3, 1, 1) * 2

    x = np.random.default_rng(0).random((2, 2, 32, 32), dtype=np.float32)
    out = cellpose_ref.network_output(x, forward, {"tile": 32, "tile_overlap": 0.1}, "cpu")
    assert calls == [(2, 2, 32, 32)] and np.array_equal(out, np.repeat(x[:, :1], 3, axis=1) * 2)


def test_tiles_merge_to_the_whole_field_for_a_pixelwise_network():
    """A network that acts on each pixel alone gives, tiled and merged
    under the taper, what it gives on the whole field."""
    def forward(x):
        return torch.cat([x[:, :1] * 3 - x[:, 1:2], x[:, 1:2] ** 2, x.sum(1, keepdim=True)], dim=1)

    x = np.random.default_rng(1).random((2, 2, 70, 45), dtype=np.float32)
    net = {"tile": 32, "tile_overlap": 0.1}
    assert cellpose_ref.tile_starts(70, 32, 0.1) == [0, 28, 38]
    out = cellpose_ref.network_output(x, forward, net, "cpu")
    np.testing.assert_allclose(out, forward(torch.as_tensor(x)).numpy(), rtol=1e-6, atol=1e-6)


def test_taper_ramps_from_each_edge():
    win = cellpose_ref.taper(40)
    # 0.1 x 40 + 1 = 5 pixels: 1/5 at the edge, 1 from the fifth pixel in
    assert win[0, 0] == pytest.approx(1 / 25) and win[20, 0] == pytest.approx(1 / 5)
    assert win[4, 4] == 1.0 and win[20, 20] == 1.0 and np.array_equal(win, win.T)
