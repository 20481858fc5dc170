"""The dead-cell classifier (``models/xgb.py``) against the reference on a
hand-written xgboost >= 1.7 JSON ensemble with NaN features, default-left
branches and trees of uneven depth: margins to 1e-6, equal dead flags."""

import numpy as np
import pytest
import torch

from saguaro_tpu.models.xgb import XGBEnsemble as RefXGB
from saguaro_tpu_torch.models.xgb import XGBEnsemble

from .torch_data import share_cpu_threads, xgb_model_json

share_cpu_threads()

N_FEATURES = 24


def _features(seed: int, n: int = 300) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, N_FEATURES)).astype(np.float32)
    x[rng.random(x.shape) < 0.2] = np.nan
    x[0] = np.nan  # a row with every value missing walks the default branches
    return x


@pytest.mark.parametrize("seed,base_score", [(0, 0.35), (1, 0.5), (2, 0.8)])
def test_margins_and_dead_flags_match_reference(seed, base_score):
    text = xgb_model_json(N_FEATURES, seed=seed, base_score=base_score)
    ref, port = RefXGB.from_json(text), XGBEnsemble.from_json(text, device="cpu")
    assert port.max_depth == ref.max_depth and port.base_margin == ref.base_margin
    x = _features(seed)
    want = np.asarray(ref.predict_margin(x))
    got = port.predict_margin(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(port.predict_dead(x).numpy(), np.asarray(ref.predict_dead(x)))
    np.testing.assert_allclose(port.predict(x).numpy(), np.asarray(ref.predict(x)), rtol=0, atol=1e-6)


def test_trees_are_uneven_and_take_default_branches():
    """The fixture really has what the parity test is for: leaves at several
    depths, splits whose default goes left and right, and rows whose result
    changes when their NaNs are filled."""
    port = XGBEnsemble.from_json(xgb_model_json(N_FEATURES, seed=0), device="cpu")
    is_leaf = port.left < 0
    assert 0 < int(is_leaf.sum()) < is_leaf.numel()
    split_defaults = port.default_left[~is_leaf & (port.right >= 0)]
    assert split_defaults.any() and not split_defaults.all()
    x = _features(0)
    filled = np.nan_to_num(x, nan=5.0)
    assert not torch.equal(port.predict_margin(x), port.predict_margin(filled))


def test_reads_a_file_and_other_objectives(tmp_path):
    """A path is read through ``io.storage``; an objective other than
    ``binary:logistic`` predicts the margin plus the raw base score."""
    text = xgb_model_json(N_FEATURES, seed=3, base_score=0.25, objective="reg:squarederror")
    path = tmp_path / "model.json"
    path.write_text(text)
    port, ref = XGBEnsemble.from_json(str(path), device="cpu"), RefXGB.from_json(str(path))
    x = _features(3, n=50)
    assert port.base_margin == 0.25
    np.testing.assert_allclose(port.predict(x).numpy(), np.asarray(ref.predict(x)), rtol=0, atol=1e-6)
