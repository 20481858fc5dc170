"""The two-level Costes descent (``costes_fine_refine``): the port (plain
forms on the CPU) against the reference and CP's f64 descent, on the
reference's own fixture (``tests/test_colocalization.py``: 96², seed 3,
uint16-grid values, ``fast`` True and False) and a site batch.

* the coarse bracket (``return_bracket``): the stopping and the previously
  visited grid index exact (the port evaluates the statistic in exact
  integer moments, the reference in f32; on these fixtures no sign flips),
  the regression line 1e-6;
* the fine thresholds: within 2 fine steps of ``cp_linear_costes_oracle``
  (the reference's own bound) and of the reference's ``costes_fine_refine``
  (the stopping step sits at the Pearson sign change, and the moments are
  rounded differently: the reference subtracts the rectangle's f32 sums,
  split into bf16 hi + lo, from the inside total; the port sums the region
  below from f32 bin sums in f64);
* the measurement: the Costes columns of ``measure_site`` with
  ``costes_fine_scale=65535`` within ``torch_data.feature_tolerance`` of
  the reference's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saguaro_tpu.kernels import colocalization as ref
from saguaro_tpu_torch.kernels import colocalization as port

from .oracles import cp_linear_costes_oracle
from .torch_data import feature_tolerance, share_cpu_threads

share_cpu_threads()

STEP = 1.0 / 65535


def _labels(shape=(96, 96)):
    lab = np.zeros(shape, np.int32)
    lab[4:28, 6:30] = 1
    lab[36:70, 10:44] = 2
    lab[50:90, 55:92] = 3
    return lab


def _uint16_pair(seed, shape=(96, 96)):
    """The reference fixture's uint16-grid channel pair, normalized."""
    rng = np.random.default_rng(seed)
    raw_f = rng.integers(0, 60000, shape)
    raw_s = np.clip(0.55 * raw_f + 0.45 * rng.integers(0, 60000, shape), 0, 65535).astype(np.int64)
    return (raw_f / 65535).astype(np.float32), (raw_s / 65535).astype(np.float32)


@pytest.fixture(scope="module")
def fixture_site():
    fi, si = _uint16_pair(3)
    inside = _labels().reshape(-1) > 0
    vals = np.stack([fi.reshape(-1), si.reshape(-1)], axis=1)
    return fi, si, inside, vals


@pytest.mark.parametrize("fast", [True, False])
def test_bracket_matches_reference(fixture_site, fast):
    _, _, inside, vals = fixture_site
    tf, ts, (regs, thr_k, prev_k) = port.costes_thresholds(
        torch.from_numpy(vals[None]), torch.from_numpy(inside[None]), ((0, 1),), scale=255,
        fast=fast, return_bracket=True)
    rf, rs, (r_regs, r_thr, r_prev) = ref.costes_thresholds(
        jnp.asarray(vals), jnp.asarray(inside), ((0, 1),), scale=255, fast=fast,
        return_bracket=True)
    np.testing.assert_array_equal(tf[0].numpy(), np.asarray(rf))
    np.testing.assert_array_equal(thr_k[0].numpy(), np.asarray(r_thr))
    np.testing.assert_array_equal(prev_k[0].numpy(), np.asarray(r_prev))
    np.testing.assert_allclose(regs[0].numpy(), np.asarray(r_regs), rtol=1e-6, atol=1e-6)
    assert float(prev_k[0, 0]) > float(thr_k[0, 0])


@pytest.mark.parametrize("fast", [True, False])
def test_fine_thresholds_match_cp_and_reference(fixture_site, fast):
    fi, si, inside, vals = fixture_site
    want_f, want_s = cp_linear_costes_oracle(
        fi.reshape(-1)[inside].astype(np.float64), si.reshape(-1)[inside].astype(np.float64),
        65535, fast)
    v, ins = torch.from_numpy(vals[None]), torch.from_numpy(inside[None])
    coarse_f, _, (regs, _, prev_k) = port.costes_thresholds(
        v, ins, ((0, 1),), scale=255, fast=fast, return_bracket=True)
    got_f, got_s = port.costes_fine_refine(v, ins, ((0, 1),), regs, prev_k, scale=255,
                                           fine=65535, fast=fast)
    _, _, (r_regs, _, r_prev) = ref.costes_thresholds(
        jnp.asarray(vals), jnp.asarray(inside), ((0, 1),), scale=255, fast=fast,
        return_bracket=True)
    ref_f, ref_s = ref.costes_fine_refine(jnp.asarray(vals), jnp.asarray(inside), ((0, 1),),
                                          r_regs, r_prev, scale=255, fine=65535, fast=fast)
    got_f, got_s = float(got_f[0, 0]), float(got_s[0, 0])
    # the coarse grid cannot express CP's threshold; the fine descent does
    assert abs(float(coarse_f[0, 0]) - want_f) > STEP
    assert abs(got_f - want_f) <= 2 * STEP
    assert abs(got_s - want_s) <= abs(want_s) * 1e-3 + 2 * STEP
    assert abs(got_f - float(ref_f[0])) <= 2 * STEP
    assert abs(got_s - float(ref_s[0])) <= abs(float(ref_s[0])) * 1e-3 + 2 * STEP
    # a multiple of the fine step
    assert abs(got_f * 65535 - round(got_f * 65535)) < 1e-3


@pytest.mark.parametrize("fast", [True, False])
def test_no_fine_walk_runs_off_its_window(fixture_site, fast):
    """``return_truncated``: on the reference's fixture every walk stops on
    CP's rule inside its window, and the thresholds are those returned
    without the flag."""
    _, _, inside, vals = fixture_site
    v, ins = torch.from_numpy(vals[None]), torch.from_numpy(inside[None])
    _, _, (regs, _, prev_k) = port.costes_thresholds(v, ins, ((0, 1),), fast=fast,
                                                     return_bracket=True)
    got_f, got_s, truncated = port.costes_fine_refine(v, ins, ((0, 1),), regs, prev_k, fast=fast,
                                                      return_truncated=True)
    want_f, want_s = port.costes_fine_refine(v, ins, ((0, 1),), regs, prev_k, fast=fast)
    assert truncated.shape == (1, 1) and not truncated.any()
    assert torch.equal(got_f, want_f) and torch.equal(got_s, want_s)


@pytest.mark.parametrize("fast", [True, False])
def test_fine_walk_flags_running_off_the_window(fast):
    """A Pearson that stays positive over the whole window: the walk ends at
    a candidate inside it and says it ran off; one that turns negative
    stops there; at the grid's floor the walk ends without running off."""
    m = port.fine_candidates(255, 65535, fast)
    t, off = port._fine_walk([0.3] * m, [100.0] * m, 10000.0, fast)
    assert off and 0 <= t < m
    pear = [0.3] * m
    pear[40] = -0.1
    t, off = port._fine_walk(pear, [100.0] * m, 10000.0, fast)
    assert not off and t == 40
    t, off = port._fine_walk([0.3] * m, [100.0] * m, 30.0, fast)
    assert not off and t == 28


def test_fine_descent_per_site_and_pair():
    """A 2-site, 3-channel batch (pairs on the sums' batch axis, one pair a
    chunk, so the sums run in three chunks): each site's and pair's fine
    threshold within 2 fine steps of the reference's on that site alone,
    for positive and negative slopes."""
    rng = np.random.default_rng(8)
    shape = (48, 52)
    b, pairs = 2, ((0, 1), (0, 2), (1, 2))
    vals = np.zeros((b, shape[0] * shape[1], 3), np.float32)
    for s in range(b):
        a = rng.integers(0, 60000, shape)
        pos = np.clip(0.6 * a + 0.4 * rng.integers(0, 60000, shape), 0, 65535)
        neg = np.clip(60000 - 0.5 * a + 0.3 * rng.integers(0, 20000, shape), 0, 65535)
        vals[s] = (np.stack([a, pos, neg], -1).reshape(-1, 3).astype(np.int64) / 65535)
    lab = _labels(shape)
    inside = np.stack([lab.reshape(-1) > 0, np.roll(lab, 3, 1).reshape(-1) > 0])
    v, ins = torch.from_numpy(vals), torch.from_numpy(inside)
    old = port.FINE_LANE_BYTES
    port.FINE_LANE_BYTES = 1  # one pair a chunk
    try:
        _, _, (regs, _, prev_k) = port.costes_thresholds(v, ins, pairs, return_bracket=True)
        got_f, got_s = port.costes_fine_refine(v, ins, pairs, regs, prev_k)
    finally:
        port.FINE_LANE_BYTES = old
    assert (regs[..., 0] < 0).any() and (regs[..., 0] > 0).any()
    for s in range(b):
        _, _, (r_regs, _, r_prev) = ref.costes_thresholds(
            jnp.asarray(vals[s]), jnp.asarray(inside[s]), pairs, return_bracket=True)
        rf, rs = ref.costes_fine_refine(jnp.asarray(vals[s]), jnp.asarray(inside[s]), pairs,
                                        r_regs, r_prev)
        np.testing.assert_allclose(got_f[s].numpy(), np.asarray(rf), rtol=0, atol=2 * STEP)
        np.testing.assert_allclose(got_s[s].numpy(), np.asarray(rs),
                                   rtol=1e-3, atol=2 * STEP)


def test_config_knob_runs_through_measurement():
    """The reference's measurement case: ``costes_fine_scale=65535`` rides
    FeatureConfig through ``measure_site``; every Costes column finite and
    within the feature tolerance of the reference's."""
    from saguaro_tpu.pipeline.features import FeatureConfig as RefConfig
    from saguaro_tpu.pipeline.features import measure_site as ref_measure
    from saguaro_tpu_torch.pipeline.features import FeatureConfig, measure_site

    rng = np.random.default_rng(4)
    lab = np.zeros((64, 64), np.int32)
    lab[10:30, 10:30] = 1
    img = rng.integers(50, 60000, (64, 64, 2)).astype(np.uint16)
    kw = dict(channels=("DNA", "ER"), max_cells=4, measure_zernike=False, measure_moments=False,
              measure_convex=False, measure_radius=False, measure_texture=False,
              measure_radial=False, measure_neighbors=False, secondary_iterations=4,
              costes_fine_scale=65535)
    got = measure_site(img, lab, FeatureConfig(**kw), device="cpu")
    want = ref_measure(img, lab, RefConfig(**kw))
    for name in ("Nuclei", "Cells", "Cytoplasm"):
        cols = [c for c in want[name].columns if c.startswith("Correlation_Costes")]
        assert cols and cols == [c for c in got[name].columns if c.startswith("Correlation_Costes")]
        for c in cols:
            g = got[name][c].to_numpy(np.float64)
            r = want[name][c].to_numpy(np.float64)
            assert np.isfinite(g).all()
            tol = feature_tolerance(c, r, want[name], 64, 64)
            assert np.all(np.abs(g - r) <= tol), (name, c, g, r)
