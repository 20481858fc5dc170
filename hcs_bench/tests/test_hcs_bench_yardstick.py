"""The yardstick's counts against shapes worked by hand (each network's
FLOPs: ``test_hcs_bench_networks.py``)."""

from __future__ import annotations

import pytest
import torch

from hcs_bench import yardstick as ys


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


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
