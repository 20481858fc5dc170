"""The CUDA kernels K1-K4 against their plain twins on the same CUDA
tensors: K1 and K2 exactly; K3 to 1e-5 of the per-label sum of |value|
(f32 atomics sum in a run-dependent order); K4 against its plain form in
f64, to 1e-5 of each lane's rounding scale (``magnitude=True``: the sum of
|lane|, and for Zernike lanes of the radial terms' magnitudes); counted
lanes (areas, small-integer sums) exactly. Marker ``cuda``: skipped without a card. The
file imports neither JAX nor the reference, so it runs on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from saguaro_tpu_torch.kernels import segment_cuda as sc
from saguaro_tpu_torch.kernels.segment_reduce import perimeter_weight_image

from .torch_data import blob_sites


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_counts_kernel_exact(cuda):
    rng = np.random.default_rng(0)
    lab = torch.from_numpy(rng.integers(-1, 300, (3, 50000)).astype(np.int32)).to(cuda)
    codes = torch.from_numpy(rng.integers(-1, 9, (3, 2, 50000)).astype(np.int32)).to(cuda)
    got = sc.seg_counts(lab, codes, (8, 5), 256)
    torch.cuda.synchronize()
    want = sc.counts_plain(lab, codes, (8, 5), 256)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_take_kernel_exact(cuda):
    rng = np.random.default_rng(1)
    table = rng.normal(0, 1e3, (3, 512, 7)).astype(np.float32)
    table[:, 10, 2], table[:, 11, 3], table[:, 12, 0] = 3.4e38, -np.inf, np.nan
    t = torch.from_numpy(table).to(cuda)
    seg = torch.from_numpy(rng.integers(-3, 520, (3, 40000)).astype(np.int32)).to(cuda)
    got = sc.seg_take_t(t, seg, 512)
    torch.cuda.synchronize()
    assert torch.equal(got, sc.take_t_plain(t, seg, 512))


@pytest.mark.cuda
def test_sums_kernel(cuda):
    rng = np.random.default_rng(2)
    lab = torch.from_numpy(rng.integers(-1, 600, (2, 70000)).astype(np.int32)).to(cuda)
    vals = torch.from_numpy(rng.normal(0, 100, (2, 70000, 40)).astype(np.float32)).to(cuda)
    vals[..., 0] = torch.from_numpy(rng.integers(-2, 2, (2, 70000)).astype(np.float32)).to(cuda)
    got = sc.seg_sums(lab, vals, 512)
    torch.cuda.synchronize()
    want = sc.sums_plain(lab, vals, 512)
    scale = sc.sums_plain(lab, vals.abs(), 512)
    assert torch.all((got - want).abs() <= 1e-5 * scale + 1e-6)
    assert torch.equal(got[..., 0], want[..., 0])


@pytest.mark.cuda
@pytest.mark.parametrize("n_ch", [1, 5])
def test_lane_kernels(cuda, n_ch):
    img, lab = blob_sites(n_sites=2, h=120, w=130, n_ch=n_ch, n_cells=30, seed=4, overflow_id=600)
    lab_t = torch.from_numpy(lab).to(cuda)
    img_t = torch.from_numpy(img).to(cuda)
    pw, border = perimeter_weight_image(lab_t)
    bnd = border.to(torch.uint8).contiguous()
    f64 = torch.float64
    got = sc.seg_lane_sums_a(lab_t, img_t, pw.contiguous(), bnd, 512, True)
    torch.cuda.synchronize()
    want = sc.lane_sums_a_plain(lab_t, img_t, pw, bnd, 512, True, dtype=f64)
    scale = sc.lane_sums_a_plain(lab_t, img_t, pw, bnd, 512, True, magnitude=True, dtype=f64)
    assert torch.all((got.double() - want).abs() <= 1e-5 * scale + 1e-6)
    assert torch.equal(got[..., 0].double(), want[..., 0])
    rng = np.random.default_rng(5)
    k_tab = sc.table_cols_c(n_ch, True, True, True)
    table = torch.from_numpy(rng.uniform(1, 100, (2, 512, k_tab)).astype(np.float32)).to(cuda)
    from saguaro_tpu_torch.kernels.zernike import _radial_coeffs

    zc = torch.as_tensor(np.array(_radial_coeffs()), dtype=torch.float32, device=cuda)
    args = (lab_t, img_t, bnd, table, zc, 512, True, True, True)
    got = sc.seg_lane_sums_c(*args)
    torch.cuda.synchronize()
    want = sc.lane_sums_c_plain(*args, dtype=f64)
    scale = sc.lane_sums_c_plain(*args, magnitude=True, dtype=f64)
    assert torch.all((got.double() - want).abs() <= 1e-5 * scale + 1e-6)
