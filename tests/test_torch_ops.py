"""The port's profile-stage numerics (``saguaro_tpu_torch.ops``) against the
reference's (``saguaro_tpu.ops``, JAX on the CPU) on the same seeded numpy
inputs: robustize (even and odd non-NaN counts, all-NaN columns),
correlations and feature selection, cosine blocks, squash and hit calling.
Values are held to 1e-6 relative in f32 (the correlations, sums of
products taken in another order, to 1e-6 absolute on values in [-1, 1]),
column lists, selected features and hit lists exactly."""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from saguaro_tpu import ops as ref
from saguaro_tpu.ops import normalize as ref_normalize
from saguaro_tpu.ops import select as ref_select
from saguaro_tpu_torch import ops as port
from saguaro_tpu_torch.ops import normalize as port_normalize
from saguaro_tpu_torch.ops import select as port_select

from .torch_data import share_cpu_threads

share_cpu_threads()

RTOL = 1e-6
CPU = "cpu"


def _robustize_case(seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """(40, 7) f32 values and a 16-row sample mask: columns with an even and
    an odd count of sample values left after NaNs, integer values that tie,
    one all-NaN column and one whose samples are all NaN."""
    rng = np.random.default_rng(seed)
    vals = rng.normal(10, 3, size=(40, 7)).astype(np.float32)
    vals[:, 3] = rng.integers(0, 5, 40)
    mask = np.zeros(40, bool)
    mask[:16] = True
    vals[[1, 5, 9], 1] = np.nan          # 13 samples left: odd
    vals[[2, 4], 2] = np.nan             # 14 left: even
    vals[:, 4] = np.nan                  # all NaN
    vals[:16, 5] = np.nan                # NaN on every sample
    vals[20:, 6] = np.nan                # NaN only outside the samples
    return vals, mask


def test_nanmedian_even_count_averages_the_middle_pair():
    """``torch.nanmedian`` returns the lower middle value of an even count;
    the reference's ``jnp.nanmedian`` (and the port) average the pair."""
    x = np.array([[1.0, 2.0, 3.0, 4.0, np.nan], [5.0, np.nan, 1.0, 3.0, 7.0]], np.float32).T
    got = port_normalize.nanmedian_cols(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.nanmedian(x, axis=0)))
    np.testing.assert_array_equal(got, [2.5, 4.0])
    assert torch.nanmedian(torch.from_numpy(x), dim=0).values[0] == 2.0


def test_mad_robustize_matches_reference():
    vals, mask = _robustize_case()
    want = np.asarray(ref_normalize.mad_robustize(jnp.asarray(vals), jnp.asarray(mask)))
    got = port_normalize.mad_robustize(torch.from_numpy(vals), torch.from_numpy(mask)).numpy()
    assert np.isnan(got[:, 4]).all() and np.isnan(got[:, 5]).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    # the even-count median differs from torch.nanmedian's
    samples = torch.from_numpy(vals[mask][:, 2])
    low = torch.nanmedian(samples).item()
    assert port_normalize.nanmedian_cols(samples[:, None]).item() != low


def test_normalize_profiles_matches_reference():
    vals, _ = _robustize_case(seed=1)
    df = pd.DataFrame(vals, columns=[f"f{i}" for i in range(vals.shape[1])])
    df.insert(0, "Metadata_Compound", ["DMSO"] * 16 + ["drug"] * 24)
    df.insert(1, "Metadata_Timepoint", "6")
    query = "Metadata_Compound == 'DMSO' and Metadata_Timepoint == '6'"
    want = ref.normalize_profiles(df, samples_query=query)
    got = port.normalize_profiles(df, samples_query=query, device=CPU)
    pd.testing.assert_frame_equal(got, want, rtol=RTOL, atol=0)


def test_annotate_matches_reference():
    profiles = pd.DataFrame({"Metadata_Well": ["A01", "A02", "A03"], "f": [1.0, 2.0, 3.0]})
    platemap = pd.DataFrame({"Metadata_Well": ["A03", "A01"], "Metadata_Compound": ["X", "DMSO"]})
    pd.testing.assert_frame_equal(port.annotate(profiles, platemap), ref.annotate(profiles, platemap))


def test_nan_aware_correlation_matches_reference():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(60, 9)).astype(np.float32)
    x[:, 3] = 2.0 * x[:, 1] + 0.01 * rng.normal(size=60)
    x[rng.random(x.shape) < 0.1] = np.nan
    x[:, 7] = 1.0               # constant: zero variance, NaN correlations
    x[:58, 8] = np.nan          # two rows of support
    want = ref_select.nan_aware_correlation(x)
    got = port_select.nan_aware_correlation(x, device=CPU)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _tied_and_huge(seed: int) -> pd.DataFrame:
    """Robust z-scores as a screen's normalize stage writes them: columns
    equal value for value (a channel's copy of a measurement, a shape
    measured in two object tables), columns whose DMSO MAD was a rounding,
    of 1e17 and beyond (their f32 squares sum past f32's range in the
    reference), and NaNs."""
    rng = np.random.default_rng(seed)
    n = 32
    base = rng.normal(size=(n, 3))
    df = pd.DataFrame(base @ rng.normal(size=(3, 10)) + 0.3 * rng.normal(size=(n, 10)),
                      columns=[f"f{i}" for i in range(10)])
    df["copy_f2"] = df["f2"]
    df["copy_f7"] = df["f7"]
    df.insert(3, "again_f7", df["f7"])
    df["huge"] = rng.normal(size=n) * 3e18
    df["huge2"] = df["huge"] * 0.5 + rng.normal(size=n) * 1e18
    df.loc[rng.random(n) < 0.1, "f5"] = np.nan
    df.insert(0, "Metadata_Well", [f"W{i:03}" for i in range(n)])
    return df


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_correlation_is_the_references_f32(seed):
    """The masked correlations are the reference's f32 bits: its matmuls sum
    each product over the rows in order, one fused multiply-add a row, and
    overflow where the reference's do (a correlation over a sum of squares
    past f32's range reads 0 or NaN)."""
    df = _tied_and_huge(seed)
    x = df.drop(columns="Metadata_Well").to_numpy(np.float32)
    want = np.asarray(ref_select.nan_aware_correlation(x))
    got = port_select.nan_aware_correlation(x, device=CPU)
    # the huge pair's sums of squares overflow: correlated, yet 0 in f32
    assert df["huge"].corr(df["huge2"]) > 0.5 and (np.nan_to_num(want[-1, :-1]) == 0).all()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_feature_select_keeps_the_references_member_of_identical_columns(seed):
    """Of columns equal value for value the reference keeps the member its
    f32 row sums of |corr| favour, and drops correlations it overflowed;
    the port keeps the same columns, in the same order."""
    df = _tied_and_huge(seed)
    kw = {"na_cutoff": 0.5, "corr_threshold": 0.95, "operation": ["correlation_threshold"]}
    want = ref.feature_select(df, **kw)
    got = port.feature_select(df, device=CPU, **kw)
    assert len(want.columns) < len(df.columns)
    assert list(got.columns) == list(want.columns)


def _selection_frame(seed: int) -> pd.DataFrame:
    """Profiles whose features each trip one selection op: a constant, a
    near-constant, a mostly-NaN, a correlated pair and an outlier."""
    rng = np.random.default_rng(seed)
    n = 80
    base = rng.normal(size=(n, 6))
    df = pd.DataFrame(base, columns=[f"f{i}" for i in range(6)])
    df["const"] = 3.0
    df["rare"] = np.where(np.arange(n) == 0, 1.0, 0.0)
    df["nan_heavy"] = np.where(rng.random(n) < 0.3, np.nan, rng.normal(size=n))
    df["twin"] = df["f0"] * 1.5 + 0.01 * rng.normal(size=n)
    df["twin2"] = -df["f2"] + 0.05 * rng.normal(size=n)
    df["outlier"] = rng.normal(size=n)
    df.loc[3, "outlier"] = 900.0
    df.insert(0, "Metadata_Well", [f"W{i:03}" for i in range(n)])
    return df


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kw", [{}, {"na_cutoff": 0.5, "corr_threshold": 0.95}])
def test_feature_select_matches_reference(seed, kw):
    df = _selection_frame(seed)
    want = ref.feature_select(df, **kw)
    got = port.feature_select(df, device=CPU, **kw)
    assert list(got.columns) == list(want.columns)
    assert "const" not in got.columns and "outlier" not in got.columns
    pd.testing.assert_frame_equal(got, want)


@pytest.mark.parametrize("copy_at", [1, 4, 6])
@pytest.mark.parametrize("rounding", [-1e-13, 0.0, 1e-13])
def test_feature_select_keeps_the_first_of_identical_columns(monkeypatch, copy_at, rounding):
    """Identical columns (a channel's copy of a measurement) have equal
    correlation sums but for rounding. The port's correlations are the
    reference's f32 bits on every device, so that an offset far below
    their resolution (``rounding``, added to one copy's correlations)
    changes nothing: the port keeps the member the reference keeps, here
    the earlier one, wherever the copy stands."""
    rng = np.random.default_rng(7)
    n = 40
    base = rng.normal(size=(n, 1))
    df = pd.DataFrame(base + 0.3 * rng.normal(size=(n, 6)), columns=[f"f{i}" for i in range(6)])
    df.insert(copy_at, "copy", df["f3"])
    exact = port_select.nan_aware_correlation

    def rounded_apart(values, device=None):
        corr = exact(values, device)
        k = list(df.columns).index("copy")
        corr[k, :] += rounding
        corr[:, k] += rounding
        return corr

    monkeypatch.setattr(port_select, "nan_aware_correlation", rounded_apart)
    got = port.feature_select(df, device=CPU, corr_threshold=0.99)
    assert list(got.columns) == list(ref.feature_select(df, corr_threshold=0.99).columns)
    first, second = sorted(["copy", "f3"], key=list(df.columns).index)
    assert first in got.columns and second not in got.columns
    assert [c for c in df.columns if c not in ("copy", "f3")] == [c for c in got.columns if c != first]


def test_pairwise_cosine_matches_reference():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(12, 30)).astype(np.float32)
    x[4] = 0.0   # a zero row: norm guarded
    want = np.asarray(ref.pairwise_cosine(x))
    got = port.pairwise_cosine(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-7)


def test_group_cosine_similarity_matches_reference():
    rng = np.random.default_rng(4)
    rows = []
    for compound, reps in (("DMSO", 6), ("a", 3), ("b", 1), ("c", 4)):
        for _ in range(reps):
            rows.append({"Metadata_Compound": compound, "Metadata_Timepoint": "6",
                         "Metadata_ConcLevel": 1, **{f"f{k}": rng.normal() for k in range(8)}})
    df = pd.DataFrame(rows)
    df.loc[2, "f3"] = np.nan
    df.index = [f"r{i}" for i in range(len(df))]
    want_avg, want_raw = ref.group_cosine_similarity(df)
    got_avg, got_raw = port.group_cosine_similarity(df, device=CPU)
    pd.testing.assert_frame_equal(got_avg, want_avg, rtol=RTOL, atol=1e-7)
    assert [r["Replicates"] for r in got_raw] == [r["Replicates"] for r in want_raw]
    for g, w in zip(got_raw, want_raw):
        np.testing.assert_allclose(g["cosine_similarities"], np.asarray(w["cosine_similarities"]),
                                   rtol=RTOL, atol=1e-7)


def test_double_sigmoid_matches_reference():
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.normal(size=200) * 5, [0.0, -100.0, 100.0, np.nan]]).astype(np.float32)
    want = np.asarray(ref.double_sigmoid(x))
    got = port.double_sigmoid(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


def _hit_profiles(seed: int) -> pd.DataFrame:
    rng = np.random.default_rng(seed)
    rows = []
    for tp in ("6", "24"):
        for w in range(24):
            compound = "DMSO" if w < 8 else f"drug{w % 5}"
            shift = 0.35 if compound in ("drug1", "drug3") else 0.0
            feats = np.clip(rng.uniform(0, 1, 12) + shift, 0, 1)
            feats[w % 12] = np.nan if w % 7 == 0 else feats[w % 12]
            rows.append({"Metadata_Plate": "P1", "Metadata_Well": f"W{w:02}",
                         "Metadata_Timepoint": tp, "Metadata_Compound": compound,
                         "Metadata_ConcLevel": 1 + w % 2, **{f"f{i}": feats[i] for i in range(12)}})
    return pd.DataFrame(rows)


def test_induction_scores_match_reference():
    df = _hit_profiles(6)
    want = ref.induction_scores(df, induction_threshold=0.6)
    got = port.induction_scores(df, induction_threshold=0.6, device=CPU)
    pd.testing.assert_series_equal(got, want)


def test_hit_calling_matches_reference():
    df = _hit_profiles(7)
    want_mean, want_thr, want_sig = ref.hit_calling(df, 0.9, 0.6)
    got_mean, got_thr, got_sig = port.hit_calling(df, 0.9, 0.6, device=CPU)
    pd.testing.assert_frame_equal(got_mean, want_mean)
    pd.testing.assert_frame_equal(got_sig, want_sig)
    assert got_thr == want_thr
    assert got_mean["Bioactive"].sum() > 0


def test_aggregate_is_the_reference_copy():
    from saguaro_tpu.ops import aggregate as ref_agg
    from saguaro_tpu_torch.ops import aggregate as port_agg

    image = pd.DataFrame({"ImageNumber": [1, 2, 3], "Metadata_Well": ["A", "A", "B"],
                          "Metadata_Site": [1, 2, 1], "ImageQC_Blur": [False, True, False]})
    cells = pd.DataFrame({"ImageNumber": [1, 1, 2, 3], "Count": [2, 4, 6, 8],
                          "Area": [1.0, 2.0, 3.0, 4.0]})
    for mod in (port_agg, ref_agg):
        assert mod.failing_image_numbers(image).tolist() == [2]
    merged = [mod.compensate_missing_sites(mod.backfill_metadata(cells, image))
              for mod in (port_agg, ref_agg)]
    pd.testing.assert_frame_equal(merged[0], merged[1])
    assert port_agg.TABLE_PREFIXES == ref_agg.TABLE_PREFIXES
