"""K1-K3 contracts: the port's plain forms (what CPU tensors get) against
the reference's XLA one-hot formulations, on the same seeded inputs.

Tolerances: counts are exact integers on both sides. The reference's
gather reconstructs each table entry from a 3-term bf16 split (~1 ulp);
the port's gather is exact, so they agree to 1 ulp. The reference's sums
split each value into bf16 hi + lo (about 16 significant bits, error
<= 2**-16 |v| per value) before an f32 accumulation; the port sums the
f32 values, so the two agree to 2**-15 of the per-label sum of |v|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saguaro_tpu.kernels import onehot_reduce as ref
from saguaro_tpu_torch.kernels import onehot_reduce as port

from .torch_data import share_cpu_threads

share_cpu_threads()

B, N, MC = 2, 3000, 16


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    labels = rng.integers(-2, MC + 4, (B, N)).astype(np.int32)  # some out of range
    codes = [
        (rng.integers(0, 8, (B, N)), rng.random((B, N)) > 0.2, 8),
        (rng.integers(0, 5, (B, N)), rng.random((B, N)) > 0.5, 3),  # codes >= n count nothing
        (np.zeros((B, N), np.int64), np.ones((B, N), bool), 1),
    ]
    return rng, labels, codes


def test_onehot_counts_exact(data):
    _, labels, codes = data
    got = port.onehot_counts(
        torch.from_numpy(labels),
        [(torch.from_numpy(c), torch.from_numpy(v), n) for c, v, n in codes],
        MC,
    )
    for b in range(B):
        want = ref.onehot_counts(
            jnp.asarray(labels[b]),
            [(jnp.asarray(c[b]), jnp.asarray(v[b]), n) for c, v, n in codes],
            MC,
        )
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[b].numpy(), np.asarray(w))


def test_onehot_counts_rejects_wide_code_space(data):
    _, labels, _ = data
    t = torch.from_numpy(labels)
    with pytest.raises(ValueError, match="int16"):
        port.onehot_counts(t, [(t, t > 0, 40000)], MC)


def _table(rng):
    t = rng.normal(0, 1000, (B, MC, 5)).astype(np.float32)
    t[:, 3, 1] = 3.4e38  # empty-label min/max sentinels read as 0
    t[:, 4, 2] = -3.4e38
    t[:, 5, 0] = np.inf
    t[:, 6, 4] = np.nan
    return t


def test_take_matches_reference_to_one_ulp(data):
    rng, labels, _ = data
    table = _table(rng)
    seg = np.clip(labels, 0, MC - 1)
    got = port.mxu_take_t(torch.from_numpy(table), torch.from_numpy(seg), MC).numpy()
    for b in range(B):
        want = np.asarray(ref.mxu_take_t(jnp.asarray(table[b]), jnp.asarray(seg[b]), MC))
        np.testing.assert_array_less(np.abs(got[b] - want), np.spacing(np.abs(want)) + 1e-30)
    # the port's gather is exact, sentinel entries included
    clean = np.where(np.isfinite(table) & (np.abs(table) < 3.38e38), table, 0.0)
    exact = np.take_along_axis(clean, seg[..., None].astype(np.int64), axis=1).transpose(0, 2, 1)
    np.testing.assert_array_equal(got, exact)


def test_take_untransposed_and_out_of_range_labels(data):
    rng, labels, _ = data
    table = _table(rng)
    got = port.mxu_take(torch.from_numpy(table), torch.from_numpy(labels), MC).numpy()
    assert got.shape == (B, N, 5)
    outside = (labels < 0) | (labels >= MC)
    assert np.all(got[outside] == 0.0)
    one_col = port.mxu_take(torch.from_numpy(table[..., 0]), torch.from_numpy(labels), MC)
    np.testing.assert_array_equal(one_col.numpy(), got[..., 0])


def test_segment_sums_within_bf16_split_tolerance(data):
    rng, labels, _ = data
    values = (rng.normal(0, 1, (B, N, 4)) * np.array([1.0, 100.0, 1e4, 3.0])).astype(np.float32)
    values[..., 3] = np.round(values[..., 3])  # small integers sum exactly
    got = port.segment_matmul_sums(torch.from_numpy(labels), torch.from_numpy(values), MC).numpy()
    for b in range(B):
        want = np.asarray(ref.segment_matmul_sums(jnp.asarray(labels[b]), jnp.asarray(values[b]), MC))
        lab = labels[b]
        ok = (lab >= 0) & (lab < MC)
        abs_sum = np.zeros((MC, 4))
        np.add.at(abs_sum, lab[ok], np.abs(values[b][ok]))
        assert np.all(np.abs(got[b] - want) <= 2.0**-15 * abs_sum + 1e-6)
        np.testing.assert_array_equal(got[b][:, 3], want[:, 3])


def test_onehot_counts_int16_codes_at_the_limit(monkeypatch):
    """Codes travel to K1 as int16: a 32768-code plane counts its top code
    32767 and drops codes outside [0, 32768) (32768, 40000, negative ones),
    exactly as the reference does."""
    rng = np.random.default_rng(4)
    labels = rng.integers(-1, 4, (B, N)).astype(np.int32)
    code = rng.integers(32600, 32768, (B, N))
    code[:, :50] = 32767
    code[:, 50:60] = 32768
    code[:, 60:70] = 40000
    code[:, 70:80] = -5
    valid = rng.random((B, N)) > 0.1
    codes = [(code, valid, 32768), (code % 7, valid, 5)]
    seen = []
    plain = port.sc.counts_plain

    def spy(lab, code_arr, sizes, mc):
        seen.append(code_arr.dtype)
        return plain(lab, code_arr, sizes, mc)

    monkeypatch.setattr(port.sc, "counts_plain", spy)
    got = port.onehot_counts(
        torch.from_numpy(labels), [(torch.from_numpy(c), torch.from_numpy(v), n) for c, v, n in codes], 4
    )
    assert seen == [torch.int16]
    assert float(got[0][..., 32767].sum()) > 0
    for b in range(B):
        want = ref.onehot_counts(
            jnp.asarray(labels[b]), [(jnp.asarray(c[b]), jnp.asarray(v[b]), n) for c, v, n in codes], 4
        )
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[b].numpy(), np.asarray(w))


def test_onehot_counts_label_valid_keeps_only_its_pixels(data):
    """``label_valid`` counts only its pixels, in every plane: the
    reference's counts with each plane's valid mask narrowed to it."""
    rng, labels, codes = data
    keep = rng.random((B, N)) > 0.3
    got = port.onehot_counts(
        torch.from_numpy(labels),
        [(torch.from_numpy(c), torch.from_numpy(v), n) for c, v, n in codes],
        MC,
        label_valid=torch.from_numpy(keep),
    )
    for b in range(B):
        want = ref.onehot_counts(
            jnp.asarray(labels[b]),
            [(jnp.asarray(c[b]), jnp.asarray(v[b] & keep[b]), n) for c, v, n in codes],
            MC,
        )
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[b].numpy(), np.asarray(w))


@pytest.mark.parametrize("scope", ["global", "adaptive"])
def test_callers_label_masks_change_no_count(monkeypatch, scope):
    """Every caller of ``onehot_counts`` on the measurement path passes a
    ``label_valid`` that its planes' valid masks imply: its counts with the
    mask equal those without. Runs ``measure_site_batch`` at the default
    FeatureConfig (adaptive: the secondary threshold's adaptive scope) on
    small seeded sites, with every call checked."""
    import dataclasses
    import sys

    from saguaro_tpu_torch.kernels import colocalization, glcm, objects_extra, shape_extra, thresholding
    from saguaro_tpu_torch.pipeline.features import FeatureConfig, measure_site_batch

    from .torch_data import blob_sites

    seen = set()

    def checked(labels, codes, max_cells, label_valid=None):
        f = sys._getframe(1)
        assert label_valid is not None, f"{f.f_code.co_name}:{f.f_lineno} passes no label_valid"
        got = port.onehot_counts(labels, codes, max_cells, label_valid)
        for g, w in zip(got, port.onehot_counts(labels, codes, max_cells)):
            assert torch.equal(g, w), f"{f.f_code.co_name}:{f.f_lineno} drops counts"
        seen.add(f.f_code.co_name)
        return got

    for mod in (colocalization, glcm, objects_extra, shape_extra, thresholding):
        monkeypatch.setattr(mod, "onehot_counts", checked)
    img, lab = blob_sites(n_sites=2, h=48, w=52, n_ch=3, n_cells=7, seed=5)
    cfg = FeatureConfig(channels=("DNA", "ER", "Mito"), max_cells=16)
    if scope == "adaptive":
        cfg = dataclasses.replace(cfg, secondary_threshold_scope="adaptive",
                                  secondary_adaptive_window=12)
    measure_site_batch(img, lab, cfg, device="cpu")
    want = {"radius_features", "object_glcm_multichannel", "_two_level_ranks",
            "neighbor_features", "_value_count_tables", "_joint_tables"}
    want.add("_hist" if scope == "global" else "adaptive_threshold")
    assert want <= seen, want - seen
