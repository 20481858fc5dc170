"""The check's numbers and the references' own pieces, by hand: the label
gap, the table tolerances, the mask recovery's rule and the measurement's
definitions on small fields."""

from __future__ import annotations

import numpy as np
import pandas as pd
import pytest

from hcs_bench import check
from hcs_bench.reference import cellpose_ref, cp_measure


def two_discs(size=40):
    yy, xx = np.mgrid[0:size, 0:size]
    lab = np.zeros((size, size), np.int32)
    lab[(yy - 10) ** 2 + (xx - 10) ** 2 <= 36] = 1
    lab[(yy - 28) ** 2 + (xx - 28) ** 2 <= 49] = 2
    return lab


def test_label_gap_is_zero_for_the_same_labels_in_another_numbering():
    lab = two_discs()
    other = np.where(lab > 0, 3 - lab, 0)
    assert check.label_px_off(lab[None], other[None]) == 0.0


def test_label_gap_keeps_a_split_object_and_counts_lost_foreground():
    lab = two_discs()
    split = lab.copy()
    split[(lab == 2) & (np.arange(40)[None, :] > 28)] = 3
    assert check.label_px_off(split[None], lab[None]) == 0.0
    lost = np.where(lab == 1, 0, lab)
    assert check.label_px_off(lost[None], lab[None]) == pytest.approx((lab == 1).sum() / (lab > 0).sum())


def test_label_gap_pools_the_batch():
    lab = two_discs()
    empty = np.zeros_like(lab)
    # one site of two all wrong: half of the batch's foreground
    assert check.label_px_off(np.stack([lab, empty]), np.stack([lab, lab])) == pytest.approx(0.5)


def test_objects_off_is_zero_for_the_same_objects_in_another_numbering():
    lab = two_discs()
    other = np.where(lab > 0, 3 - lab, 0)
    assert check.objects_off_by_site(other[None], lab[None]).tolist() == [0.0]


def test_objects_off_counts_a_split_and_a_lost_object_on_either_side():
    lab = two_discs()
    split = lab.copy()
    split[(lab == 2) & (np.arange(40)[None, :] > 28)] = 3
    # the program's 2 keeps the larger part of disc 2 (IoU over 0.5), its 3
    # has no partner: one of its three objects
    assert check.objects_off_by_site(split[None], lab[None])[0] == pytest.approx(1 / 3)
    lost = np.where(lab == 1, 0, lab)
    assert check.objects_off_by_site(lost[None], lab[None])[0] == pytest.approx(1 / 2)
    assert check.objects_off_by_site(lab[None], lost[None])[0] == pytest.approx(1 / 2)


def test_objects_off_at_iou_one_half():
    lab = np.zeros((10, 10), np.int32)
    lab[0:4, 0:4] = 1
    half = np.zeros_like(lab)
    half[0:4, 0:2] = 1  # IoU 8/16
    assert check.objects_off_by_site(half[None], lab[None])[0] == 0.0
    half[0, 0] = 0  # IoU 7/16
    assert check.objects_off_by_site(half[None], lab[None])[0] == 1.0


def test_objects_off_empty_and_missing_sites():
    lab, empty = two_discs(), np.zeros((40, 40), np.int32)
    assert check.objects_off_by_site(np.stack([empty, lab]), np.stack([empty, empty])).tolist() == [0.0, 1.0]
    # a site missing on the program's side reads 1
    assert check.objects_off_by_site(lab[None], np.stack([lab, lab])).tolist() == [0.0, 1.0]


def test_pointer_steps_reach_the_centre_and_one_seed_a_disc():
    lab = two_discs()
    flows = np.zeros((2, 40, 40))
    gy, gx = np.mgrid[0:40, 0:40].astype(float)
    for k, (cy, cx) in ((1, (10, 10)), (2, (28, 28))):
        m = lab == k
        d = np.hypot(cy - gy, cx - gx) + 1e-9
        flows[0][m], flows[1][m] = ((cy - gy) / d)[m], ((cx - gx) / d)[m]
    start, end = cellpose_ref.follow_flows(flows, lab > 0, 256)
    assert set(map(tuple, end.T[lab[start[0], start[1]] == 1])) <= {(9, 9), (9, 10), (10, 9), (10, 10),
                                                                    (10, 11), (11, 10), (11, 11)}
    got = cellpose_ref.relabel(cellpose_ref.get_masks(start, end, lab.shape), 1)
    assert check.label_px_off(got[None], lab[None]) == 0.0
    # the designed flows point to each centroid: nothing is dropped
    assert np.array_equal(cellpose_ref.drop_bad_flow_masks(got, 5.0 * flows, 0.4, 512), got)


def test_flow_qc_drops_a_mask_whose_flows_point_away():
    lab = two_discs()
    gy, gx = np.mgrid[0:40, 0:40].astype(float)
    d = np.hypot(10 - gy, 10 - gx) + 1e-9
    flows = np.zeros((2, 40, 40))
    flows[0][lab == 1], flows[1][lab == 1] = (5 * (10 - gy) / d)[lab == 1], (5 * (10 - gx) / d)[lab == 1]
    flows[0][lab == 2] = 5.0  # all one way: far from the centroid field
    kept = cellpose_ref.drop_bad_flow_masks(lab, flows, 0.4, 512)
    assert np.array_equal(kept, np.where(lab == 1, 1, 0))


def test_fill_holes_takes_the_ring_label():
    lab = two_discs()
    lab[10, 10] = 0
    assert cellpose_ref.fill_holes(lab)[10, 10] == 1


def test_resize_rows_sum_to_one_and_nearest_up_is_half_pixel():
    w = cellpose_ref.resize_weights(1080, 184)
    assert w.shape == (184, 1080) and np.allclose(w.sum(axis=1), 1.0)
    up = cellpose_ref.nearest_up(np.arange(4).reshape(2, 2), 5, 5)
    assert up[:, 0].tolist() == [0, 0, 2, 2, 2]


def test_object_intensity_by_hand():
    lab = np.zeros((6, 6), np.int32)
    lab[1:3, 1:4] = 1
    img = np.zeros((6, 6, 1), np.uint16)
    img[1:3, 1:4, 0] = [[1, 2, 3], [4, 5, 9]]
    row = cp_measure.nuclei_table(img, lab, ["DNA"]).iloc[0]
    assert row["AreaShape_Area"] == 6 and row["Intensity_IntegratedIntensity_DNA"] == 24
    assert row["Intensity_MeanIntensity_DNA"] == 4 and row["Intensity_MaxIntensity_DNA"] == 9
    assert row["Location_MaxIntensity_X_DNA"] == 3 and row["Location_MaxIntensity_Y_DNA"] == 2
    assert row["Location_Center_X"] == 2 and row["Location_Center_Y"] == 1.5
    cx = (1 * 5 + 2 * 7 + 3 * 12) / 24
    assert row["Location_CenterMassIntensity_X_DNA"] == pytest.approx(cx)
    assert row["AreaShape_MaximumRadius"] == 1.0


def test_mass_displacement_tolerance_is_a_share_of_the_side():
    t = pd.DataFrame([{"Intensity_MassDisplacement_DNA": 0.7}])
    assert check.feature_tolerance("Intensity_MassDisplacement_DNA", np.array([0.7]), t, 100, 100)[0] \
        == pytest.approx(1e-3)
