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
