"""The yardstick's counts against shapes worked by hand."""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from hcs_bench import yardstick as ys

BENCH = Path(__file__).resolve().parents[1]


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def block(cin, cout, side):
    """proj 1x1, conv_0 3x3, conv_1..3 3x3, 2 FLOPs a multiply-add"""
    return 2 * side * side * (cin * cout + cin * cout * 9 + 3 * cout * cout * 9)


def test_cpnet_tiny_by_hand():
    # down 1->2 at 4x4: 2*16*(2 + 18 + 108) = 4096; up 2->2 at 4x4:
    # 2*16*(4 + 36 + 108) = 4736; head 1x1 2->3: 2*16*6 = 192
    assert ys.cpnet_conv_flops((2,), 1, 4) == 4096 + 4736 + 192


def test_cpnet_published_widths():
    want = (block(2, 32, 224) + block(32, 64, 112) + block(64, 128, 56) + block(128, 256, 28)
            + block(64, 32, 224) + block(128, 64, 112) + block(256, 128, 56) + block(256, 256, 28)
            + 2 * 224 * 224 * 32 * 3)
    assert ys.cpnet_conv_flops((32, 64, 128, 256), 2, 224) == want


def test_cpnet_site_tiles():
    cp = {"features": [32, 64, 128, 256], "n_channels": 2, "diam_mean": 30.0, "tile": 224,
          "tile_overlap": 0.1}
    # 1080 * 30 / 100 = 324: tiles at 0 and 100 on each axis
    assert ys.tile_starts(324, 224, 0.1) == [0, 100]
    assert ys.cpnet_site_flops(cp, 100.0, 1080, 1080) == 4 * ys.cpnet_conv_flops((32, 64, 128, 256), 2, 224)
    assert ys.tile_starts(200, 224, 0.1) == [0]
    # the nuclei model's diam_mean 17: 1080 * 17 / 100 = 184, one tile
    nuclei = dict(cp, diam_mean=17.0)
    assert ys.cpnet_site_flops(nuclei, 100.0, 1080, 1080) == ys.cpnet_conv_flops((32, 64, 128, 256), 2, 224)


def test_effnet_tiny_by_hand():
    ef = {"stem_filters": 8, "head_filters": 32,
          "stages": [["fused", 1, 3, 1, 8, 1, 0.0], ["mbconv", 2, 3, 2, 16, 1, 0.25]]}
    # stem 1->8 3x3/2 at 4x4: 1152; fused 8->8 3x3: 9216; expand 8->16 1x1:
    # 2048; depthwise 16 3x3/2 at 2x2: 576; SE 2*16*2: 64; project 16->16
    # at 2x2: 1024; head 16->32 at 2x2: 2048
    macs, n_bytes = ys.effnet_cost(ef, 8, in_ch=1)
    assert macs == 1152 + 9216 + 2048 + 576 + 64 + 1024 + 2048
    assert n_bytes == 4 * (128 + 128 + 256 + 64 + 64 + 128) + 4 * 64


def test_effnetv2_l_at_480():
    cfg = json.loads((BENCH / "configs" / "cellpose_nuclei.effnetv2_l.json").read_text())
    macs, _ = ys.effnet_cost(cfg["effnet"], 480, in_ch=3)
    # timm lists tf_efficientnetv2_l at 480 as 56.4 GMACs
    assert 55e9 < macs < 57e9


def test_bound():
    assert ys.bound(3.35e12, 0.0) == (1.0, "bytes")
    assert ys.bound(0.0, 67e12) == (1.0, "operations")


@pytest.mark.parametrize("name,args,want", [
    ("seg_counts", (meta(2, 10, dtype=torch.int32), meta(2, 3, 10, dtype=torch.int16), (4, 4, 8), 16, 7.0),
     (4 * 20 + 2 * 7 * 3 + 4 * 2 * 16 * 16, 0.0)),
    ("seg_take_t", (meta(2, 16, 3), meta(2, 10, dtype=torch.int32), 16), (4 * 2 * (48 + 10 + 30), 0.0)),
    ("seg_sums", (meta(2, 10, dtype=torch.int32), meta(2, 10, 4), 16), (20 * 20 + 4 * 2 * 16 * 4, 80.0)),
    ("seg_edt_sweep", (meta(2, 5, 4), meta(2, 5, 4), 64), (12 * 40, 0.0)),
    ("seg_pick2", (meta(2, 10, 5, dtype=torch.int32), meta(2, 10, 5, dtype=torch.int32),
                   meta(2, 5, 256, 256, 3)), (2 * 10 * 5 * (8 + 12) + 4 * 2 * 5 * 65536 * 3, 0.0)),
    ("seg_radial_sums", (meta(2, 10, dtype=torch.int32), meta(2, 10, dtype=torch.int32), meta(2, 10, 5),
                         16, 32, 6.0), (8 * 20 + 4 * 5 * 6 + 4 * 2 * 16 * 32 * 6, 36.0)),
])
def test_kernel_work(name, args, want):
    assert ys.WORK[name](*args) == want


def test_lane_kernels_work():
    lab, img = meta(2, 4, 5, dtype=torch.int32), meta(2, 4, 5, 3)
    n_a = ys.n_lanes_a(3, True)
    assert ys.WORK["seg_lane_sums_a"](lab, img, None, None, 16, True) == (40 * 21 + 4 * 2 * 16 * n_a, 0.0)
    n_c = ys.n_lanes_c(3, True, True, True)
    got = ys.WORK["seg_lane_sums_c"](lab, img, None, meta(2, 16, 7), None, 16, True, True, True)
    assert got == (40 * 17 + 4 * 2 * 16 * (7 + n_c), 0.0)
    n_e = ys.n_lanes_e(3)
    assert ys.WORK["seg_lane_sums_e"](meta(2, 20, dtype=torch.int32), meta(2, 20, 3), None, None, None,
                                      16) == (40 * 28 + 4 * 2 * 16 * (3 + n_e), 0.0)
    assert set(ys.WORK) == {"seg_counts", "seg_take_t", "seg_sums", "seg_lane_sums_a", "seg_lane_sums_c",
                            "seg_lane_sums_e", "seg_radial_sums", "seg_edt_sweep", "seg_pick2"}
