"""The CUDA kernels K1-K7 against their plain twins on the same CUDA
tensors: K1 and K2 exactly; K3 to 1e-5 of the per-label sum of |value|
(f32 atomics sum in a run-dependent order); K4 against its plain form in
f64, to 1e-5 of each lane's rounding scale (``magnitude=True``: the sum of
|lane|, and for Zernike lanes of the radial terms' magnitudes); counted
lanes (areas, small-integer sums) exactly; K7's sums to 1e-5 of each
output's sum of |w * x|, its rounded integers within 1 unit; K5 and K6
(in the plain form's set-major layout) exactly; K8's granularity spectrum
within rtol 1e-5 (its reconstructions are exact, its per-plane sums taken
in another order) and bit for bit from call to call. Marker
``cuda``: skipped without a card. The
file imports neither JAX nor the reference, so it runs on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

from saguaro_tpu_torch.kernels import segment_cuda as sc
from saguaro_tpu_torch.kernels.segment_reduce import perimeter_weight_image

from .torch_data import (
    PICK2_CASES,
    RADIAL_CASES,
    adversarial_lane_args_a,
    adversarial_lane_args_c,
    adversarial_lane_args_e,
    blob_sites,
    edt_adversarial_cases,
    pick2_case,
    radial_adversarial_site,
    share_cpu_threads,
)

share_cpu_threads()


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
    codes = torch.from_numpy(rng.integers(-1, 9, (3, 2, 50000)).astype(np.int16)).to(cuda)
    got = sc.seg_counts(lab, codes, (8, 5), 256)
    torch.cuda.synchronize()
    want = sc.counts_plain(lab, codes, (8, 5), 256)
    assert torch.equal(got, want)


def _counts_inputs(rng, b, n, mc, sizes):
    """K1 inputs that stress every path: labels in runs, some outside [0,
    mc); codes in runs, some outside [0, size), whole warps' worth (256
    pixels) of invalid codes; with B > 1 site 0 puts every pixel in one bin
    and the last site is empty (no valid label)."""
    def runs(lo, hi, size):
        vals = rng.integers(lo, hi, size // 5 + 1)
        return np.repeat(vals, rng.integers(1, 10, vals.size))[:size].copy() if size else vals[:0]

    lab = np.stack([np.resize(runs(-3, mc + 4, n), n) for _ in range(b)]).astype(np.int32)
    codes = np.stack([np.stack([np.resize(runs(-1, s + 2, n), n) for s in sizes])
                      for _ in range(b)]).astype(np.int16)
    for start in rng.integers(0, max(n - 256, 1), 6):
        codes[:, :, start : start + 256] = -1
    if b > 1:
        lab[0] = min(1, mc - 1)
        codes[0] = 0
        lab[-1] = rng.choice([-1, mc, mc + 5], n)
    return lab, codes


COUNTS_CASES = {
    # name: (B, N, max_cells, sizes, the path and column groups the plan picks)
    "otsu-copies": (3, 100000, 256, (1,), ("shared", 1)),
    "shared-n-odd": (2, 50003, 512, (16,) * 5, ("shared", 1)),
    "mc1": (2, 9999, 1, (7, 3), ("shared", 1)),
    "tiles2": (2, 40000, 512, (130,), ("tiles", 1)),
    "tiles3-values": (2, 40000, 256, (256, 256), ("tiles", 1)),
    "tiles-texture": (2, 30000, 512, (136,) * 20, ("tiles", 1)),
    "tiles-row-split": (2, 20000, 2, (30000, 30000), ("tiles", 2)),
    "cluster6": (2, 30000, 512, (500,), ("cluster", 1)),
    "cluster-groups": (2, 30000, 512, (512,) * 4, ("cluster", 4)),
    "split-plane-b1": (1, 20000, 1024, (1024, 1024), ("cluster", 6)),
    "int16-limit": (1, 5000, 2, (32768,), ("tiles", 1)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(COUNTS_CASES))
def test_counts_kernel_paths(cuda, case):
    """K1 exactly against its plain form on each path of its plan, reached
    through shapes where the plan picks it: one CTA with per-warp copies or
    one table; row tiles, with column groups where a row is wider than a
    slice; clusters of 6 and 8 CTAs; column groups, a plane cut over
    groups, codes at the int16 limit."""
    b, n, mc, sizes, path = COUNTS_CASES[case]
    rng = np.random.default_rng(len(case))
    lab, codes = _counts_inputs(rng, b, n, mc, sizes)
    if case == "int16-limit":
        lab[0, :100] = 0
        codes[0, 0, :100] = 32767
    plan = sc.counts_plan(mc, sizes, b, n, torch.cuda.get_device_properties(cuda).multi_processor_count)
    assert (plan.path, len(plan.groups)) == path, plan
    lab_t, codes_t = torch.from_numpy(lab).to(cuda), torch.from_numpy(codes).to(cuda)
    got = sc.seg_counts(lab_t, codes_t, sizes, mc)
    torch.cuda.synchronize()
    assert torch.equal(got, sc.counts_plain(lab_t, codes_t, sizes, mc)), plan
    if case == "int16-limit":
        assert got[0, 0, 32767] >= 100


@pytest.mark.cuda
@pytest.mark.parametrize("sizes", [(130,), (2048,)])
def test_counts_kernel_refuses_a_plan_the_card_cannot_hold(cuda, monkeypatch, sizes):
    """A plan that leaves label rows without a CTA (row tiles at (130,), a
    cluster at (2048,)) is refused by the library, and the wrapper raises."""
    lab = torch.zeros((1, 64), dtype=torch.int32, device=cuda)
    codes = torch.zeros((1, 1, 64), dtype=torch.int16, device=cuda)
    plan = sc.counts_plan(512, sizes, 1, 64)
    assert plan.ways > 1
    bad = dataclasses.replace(plan, rows=plan.rows // 2)
    monkeypatch.setattr(sc, "counts_plan", lambda *args: bad)
    with pytest.raises(RuntimeError, match="sag_counts failed"):
        sc.seg_counts(lab, codes, sizes, 512)


@pytest.mark.cuda
@pytest.mark.parametrize("with_edge", [False, True])
@pytest.mark.parametrize("max_cells", [16, 512, 1024])
@pytest.mark.parametrize("n_ch", [1, 2, 5, 8])
def test_lane_sums_a_kernel_adversarial(cuda, n_ch, max_cells, with_edge):
    """Pass A's register runs on the adversarial sites: runs across strip,
    step and row ends, single pixels, overflow ids, an all-background site
    and a ragged last span; areas exactly."""
    host = adversarial_lane_args_a(n_ch, max_cells, with_edge, seed=n_ch + max_cells)
    args = [torch.from_numpy(a).to(cuda) for a in host[:4]] + list(host[4:])
    got = sc.seg_lane_sums_a(*args)
    torch.cuda.synchronize()
    assert got.shape == (3, max_cells, sc.n_lanes_a(n_ch, with_edge))
    want = sc.lane_sums_a_plain(*args, dtype=torch.float64)
    _hold_lane_sums(got, want, sc.lane_sums_a_plain(*args, magnitude=True, dtype=torch.float64))
    assert torch.equal(got[..., 0].double(), want[..., 0])


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


def _sums_case(rng, case, b, n, k, mc):
    """K3 inputs: labels in runs (some < 0, some >= mc), values with most
    pixels 0 (the Euler stream's shape) or none, small integers in lane 0."""
    if case == "one label":
        lab = np.full((b, n), min(7, mc - 1), np.int32)
    else:
        runs = rng.integers(-3, mc + 5, b * n // 6 + 1)
        lab = np.repeat(runs, rng.integers(1, 12, runs.size))[: b * n]
        lab = np.pad(lab, (0, b * n - lab.size), constant_values=mc + 1).reshape(b, n).astype(np.int32)
    vals = rng.normal(0, 100, (b, n, k)).astype(np.float32)
    vals[..., 0] = rng.integers(-2, 3, (b, n))
    if case == "sparse":
        vals[rng.random((b, n)) < 0.97] = 0.0
    elif case == "zeros":
        vals[:] = 0.0
    return lab, vals


@pytest.mark.cuda
@pytest.mark.parametrize(
    "case,b,n,k,mc",
    [
        ("sparse", 3, 50_001, 1, 512),     # N odd: sites 2 and 3 start off a 16-byte boundary
        ("dense", 2, 40_006, 2, 512),      # N not a multiple of 4
        ("dense", 1, 70_000, 5, 1024),     # B = 1, lanes in two launches (4 + 1)
        ("dense", 4, 9_999, 2, 16),        # a small table: many pixels a slot
        ("sparse", 2, 3, 1, 512),          # sites shorter than one vector
        ("zeros", 2, 30_001, 2, 512),      # nothing to add
        ("one label", 2, 60_003, 1, 1024), # one label everywhere: one run a warp
    ],
)
def test_sums_kernel_cases(cuda, case, b, n, k, mc):
    """K3 against the plain form: lane 0 (small integers) exactly, the
    other lanes to 1e-5 of each label's sum of |value|; labels < 0 and >=
    mc dropped."""
    rng = np.random.default_rng(n + k)
    lab_h, vals_h = _sums_case(rng, case, b, n, k, mc)
    lab, vals = torch.from_numpy(lab_h).to(cuda), torch.from_numpy(vals_h).to(cuda)
    before = sc.LAUNCHES["seg_sums"]
    got = sc.seg_sums(lab, vals, mc)
    torch.cuda.synchronize()
    assert sc.LAUNCHES["seg_sums"] == before + len(sc.sums_plan(b, n, k, mc, 528).chunks)
    want = sc.sums_plain(lab, vals, mc, dtype=torch.float64)
    scale = sc.sums_plain(lab, vals.abs(), mc, dtype=torch.float64)
    assert torch.equal(got[..., 0].double(), want[..., 0])
    assert torch.all((got.double() - want).abs() <= 1e-5 * scale + 1e-6)
    if case == "zeros":
        assert not got.any()


@pytest.mark.cuda
def test_sums_kernel_unaligned_views(cuda):
    """Labels and values that start off a 16-byte boundary (views one
    pixel into their storage) are summed like aligned copies."""
    rng = np.random.default_rng(5)
    lab_h, vals_h = _sums_case(rng, "dense", 2, 20_001, 2, 512)
    lab = torch.from_numpy(np.concatenate([np.zeros(1, np.int32), lab_h.reshape(-1)]))
    lab = lab.to(cuda)[1:].view(2, 20_001)
    vals = torch.from_numpy(np.concatenate([np.zeros((1, 2), np.float32),
                                            vals_h.reshape(-1, 2)])).to(cuda)[1:].view(2, 20_001, 2)
    assert lab.data_ptr() % 16 and vals.data_ptr() % 16
    got = sc.seg_sums(lab, vals, 512)
    want = sc.sums_plain(lab, vals, 512, dtype=torch.float64)
    scale = sc.sums_plain(lab, vals.abs(), 512, dtype=torch.float64)
    assert torch.all((got.double() - want).abs() <= 1e-5 * scale + 1e-6)


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


@pytest.mark.cuda
def test_counts_kernel_exact_at_glcm_planes(cuda):
    """20 code planes of 136 triangular codes (texture at 5 channels x 4
    directions) in one call: more planes than one block stages."""
    rng = np.random.default_rng(6)
    lab = torch.from_numpy(rng.integers(-1, 520, (2, 60000)).astype(np.int32)).to(cuda)
    codes = torch.from_numpy(rng.integers(-1, 137, (2, 20, 60000)).astype(np.int16)).to(cuda)
    sizes = (136,) * 20
    got = sc.seg_counts(lab, codes, sizes, 512)
    torch.cuda.synchronize()
    assert torch.equal(got, sc.counts_plain(lab, codes, sizes, 512))


@pytest.mark.cuda
def test_edt_sweep_kernel_exact(cuda):
    from saguaro_tpu_torch.kernels.shape_extra import _edt_sweep_inputs

    _, lab = blob_sites(n_sites=2, h=150, w=300, n_ch=1, n_cells=40, seed=7)
    v2, d2 = (t.contiguous() for t in _edt_sweep_inputs(torch.from_numpy(lab).to(cuda)))
    for radius in (1, 64):
        got = sc.seg_edt_sweep(v2, d2, radius)
        torch.cuda.synchronize()
        assert torch.equal(got, sc.edt_sweep_plain(v2, d2, radius))


def _equal_nan(got, want):
    """Bit for bit where ``want`` is a number, NaN where it is NaN."""
    return torch.equal(got.isnan(), want.isnan()) and torch.equal(got.nan_to_num(),
                                                                   want.nan_to_num())


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(edt_adversarial_cases()) + ["unaligned rows"])
def test_edt_sweep_kernel_adversarial(cuda, case):
    """K5's 16-byte and 4-byte forms and its early exit on adversarial rows
    (one label, negative, infinite and NaN values, R = 0, R >= W, W = 1,
    odd widths and radii, a sparse field, data not 16-byte aligned)."""
    from saguaro_tpu_torch.kernels.shape_extra import _edt_sweep_inputs

    if case == "unaligned rows":  # w % 4 == 0 but the data start 4 bytes past a boundary
        rng = np.random.default_rng(12)
        v2, d2 = (_unaligned(rng.integers(0, 500, (3, 2, 256)).astype(np.float32), cuda)
                  for _ in range(2))
        assert v2.data_ptr() % 16 and v2.is_contiguous()
        radius = 40
    else:
        v2, d2, radius = edt_adversarial_cases()[case]
        if d2 is None:  # labels: the sweep's inputs
            v2, d2 = (t.contiguous() for t in _edt_sweep_inputs(torch.from_numpy(v2).to(cuda)))
        else:
            v2, d2 = torch.from_numpy(v2).to(cuda), torch.from_numpy(d2).to(cuda)
    got = sc.seg_edt_sweep(v2, d2, radius)
    torch.cuda.synchronize()
    assert _equal_nan(got, sc.edt_sweep_plain(v2, d2, radius))


def _hold_pick2(hi, lo, tables):
    """K6 on CUDA tensors equal to its plain form, in the plain form's
    set-major layout: shape, strides, each set's ranks contiguous."""
    got = sc.seg_pick2(hi, lo, tables)
    torch.cuda.synchronize()
    want = sc.pick2_plain(hi, lo, tables)
    assert got.shape == want.shape == (*hi.shape, tables.shape[4])
    assert got.stride()[:3] == want.stride()[:3]
    assert all(got[..., k].is_contiguous() for k in range(tables.shape[4]))
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n_ch,k", [*PICK2_CASES, (3, 6)])
def test_pick2_kernel_exact(cuda, n_ch, k):
    """Every channel count and set count (K > 4 in chunks), B = 1 or 3, odd
    N (later sites start unaligned), codes outside [0, 256) on both sides."""
    _hold_pick2(*(torch.from_numpy(a).to(cuda) for a in pick2_case(n_ch, k, seed=8 * n_ch + k)))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 2, 3, 7, 1_025])
def test_pick2_kernel_small_sites(cuda, n):
    """Sites of fewer items than a vector, or a few vectors: the ragged
    heads and tails alone."""
    _hold_pick2(*(torch.from_numpy(a).to(cuda) for a in pick2_case(3, 2, seed=n, n=n)))


@pytest.mark.cuda
def test_pick2_kernel_unaligned_views(cuda):
    """Codes and tables whose data start 4 bytes past a 16-byte boundary:
    the wrapper copies them aligned."""
    hi, lo, tables = pick2_case(5, 3, seed=3, n=10_001)
    args = [_unaligned(a, cuda) for a in (hi, lo, tables)]
    assert all(a.data_ptr() % 16 for a in args)
    _hold_pick2(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("n_ch", [1, 2, 3, 4, 5, 6, 7, 8])
def test_radial_sums_kernel(cuda, n_ch):
    img, lab = blob_sites(n_sites=2, h=120, w=130, n_ch=n_ch, n_cells=30, seed=9, overflow_id=600)
    rng = np.random.default_rng(9)
    codes = rng.integers(0, 33, lab.shape).astype(np.int32)  # 32 = excluded
    args = (torch.from_numpy(lab).to(cuda).reshape(2, -1),
            torch.from_numpy(codes).to(cuda).reshape(2, -1),
            torch.from_numpy(img).to(cuda).reshape(2, -1, n_ch))
    got = sc.seg_radial_sums(*args, 512, 32)
    torch.cuda.synchronize()
    want = sc.radial_sums_plain(*args, 512, 32, dtype=torch.float64)
    assert torch.equal(got[..., 0].double(), want[..., 0])  # pixel counts
    assert torch.all((got.double() - want).abs() <= 1e-5 * want.abs() + 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("n_ch", [1, 2, 5, 8])
@pytest.mark.parametrize("case", RADIAL_CASES)
def test_radial_sums_kernel_adversarial(cuda, case, n_ch):
    """K4 radial's runs, hand-overs and warp merge on adversarial sites:
    counts exactly, sums to 1e-5 of their magnitude."""
    lab, codes, img, mc, n_codes = radial_adversarial_site(case, n_ch)
    args = [torch.from_numpy(a).to(cuda) for a in (lab, codes, img)]
    got = sc.seg_radial_sums(*args, mc, n_codes)
    torch.cuda.synchronize()
    want = sc.radial_sums_plain(*args, mc, n_codes, dtype=torch.float64)
    scale = sc.radial_sums_plain(args[0], args[1], args[2].abs(), mc, n_codes, dtype=torch.float64)
    assert torch.equal(got[..., 0].double(), want[..., 0])
    assert torch.all((got.double() - want).abs() <= 1e-5 * scale + 1e-6)


def _unaligned(a: np.ndarray, dev) -> torch.Tensor:
    """``a`` on ``dev``, contiguous, its data 4 bytes past a 16-byte boundary."""
    t = torch.from_numpy(a)
    flat = torch.zeros(a.size + 1, dtype=t.dtype, device=dev)
    flat[1:] = t.reshape(-1).to(dev)
    return flat[1:].view(a.shape)


@pytest.mark.cuda
def test_radial_sums_kernel_unaligned_views(cuda):
    """Inputs whose data do not start on a 16-byte boundary are copied."""
    lab, codes, img, mc, n_codes = radial_adversarial_site("runs of 1-9", 5)
    args = [_unaligned(a, cuda) for a in (lab, codes, img)]
    assert all(t.data_ptr() % 16 for t in args)
    got = sc.seg_radial_sums(*args, mc, n_codes)
    torch.cuda.synchronize()
    want = sc.radial_sums_plain(*args, mc, n_codes, dtype=torch.float64)
    scale = sc.radial_sums_plain(args[0], args[1], args[2].abs(), mc, n_codes, dtype=torch.float64)
    assert torch.equal(got[..., 0].double(), want[..., 0])
    assert torch.all((got.double() - want).abs() <= 1e-5 * scale + 1e-6)


@pytest.mark.cuda
def test_lane_sums_e_kernel(cuda):
    n_ch = 5
    img, lab = blob_sites(n_sites=2, h=120, w=130, n_ch=n_ch, n_cells=30, seed=10, overflow_id=600)
    rng = np.random.default_rng(10)
    n = lab.shape[1] * lab.shape[2]
    n_pairs = n_ch * (n_ch - 1) // 2
    ranks = rng.integers(0, 3000, (2, n, n_ch)).astype(np.float32)
    tff = rng.uniform(100, 400, (2, 512, n_ch)).astype(np.float32)
    consts = np.concatenate([rng.uniform(100, 400, (2, 2, n_pairs)),
                             np.full((2, 1, n_pairs), 1.0 / 3000.0)], axis=1).astype(np.float32)
    args = [torch.from_numpy(a).to(cuda) for a in
            (lab.reshape(2, n), img.reshape(2, n, n_ch), ranks, tff, consts)]
    got = sc.seg_lane_sums_e(*args, 512)
    torch.cuda.synchronize()
    want = sc.lane_sums_e_plain(*args, 512, dtype=torch.float64)
    scale = sc.lane_sums_e_plain(*args, 512, magnitude=True, dtype=torch.float64)
    assert got.shape == (2, 512, n_ch + 8 * n_pairs)
    assert torch.all((got.double() - want).abs() <= 1e-5 * scale + 1e-6)


def _hold_lane_sums(got, want, scale):
    """K4's hold: f32 sums against the f64 plain form to 1e-5 of each sum's
    rounding scale (passes C and E carry no count lane to hold exactly)."""
    err = (got.double() - want).abs()
    assert torch.all(err <= 1e-5 * scale + 1e-6), float((err / (1e-5 * scale + 1e-6)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("max_cells", [16, 512, 1024])
@pytest.mark.parametrize("n_ch", [1, 2, 5, 8])
@pytest.mark.parametrize("moments,zernike,edge", list(itertools.product([False, True], repeat=3)))
def test_lane_sums_c_kernel_adversarial(cuda, n_ch, max_cells, moments, zernike, edge):
    """Pass C's register runs on objects wider than a strip and a block's
    span, runs across strip, step and row ends, single pixels, overflow ids,
    an all-background site and a ragged last span, at every lane group."""
    from saguaro_tpu_torch.kernels.zernike import _radial_coeffs

    host = adversarial_lane_args_c(n_ch, max_cells, moments, zernike, edge, _radial_coeffs(),
                                   seed=n_ch + max_cells)
    args = [torch.from_numpy(a).to(cuda) for a in host[:5]] + list(host[5:])
    got = sc.seg_lane_sums_c(*args)
    torch.cuda.synchronize()
    assert got.shape == (3, max_cells, sc.n_lanes_c(n_ch, moments, zernike, edge))
    _hold_lane_sums(got, sc.lane_sums_c_plain(*args, dtype=torch.float64),
                    sc.lane_sums_c_plain(*args, magnitude=True, dtype=torch.float64))


@pytest.mark.cuda
@pytest.mark.parametrize("max_cells", [16, 512, 1024])
@pytest.mark.parametrize("n_ch", [2, 5, 8])
def test_lane_sums_e_kernel_adversarial(cuda, n_ch, max_cells):
    """Pass E's register runs on the same fixtures, every pair group."""
    host = adversarial_lane_args_e(n_ch, max_cells, seed=7 * n_ch + max_cells)
    args = [torch.from_numpy(a).to(cuda) for a in host[:5]] + [max_cells]
    got = sc.seg_lane_sums_e(*args)
    torch.cuda.synchronize()
    assert got.shape == (3, max_cells, sc.n_lanes_e(n_ch))
    _hold_lane_sums(got, sc.lane_sums_e_plain(*args, dtype=torch.float64),
                    sc.lane_sums_e_plain(*args, magnitude=True, dtype=torch.float64))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "dtype,batch,in_shape,out_shape",
    [
        (np.uint16, 3, (540, 600), (270, 300)),    # down by 2, the run point's ratio
        (np.uint16, 1, (1001, 1537), (433, 761)),  # odd, non-square, batch 1
        (np.uint8, 2, (40, 56), (97, 71)),         # upsampling
        (np.uint16, 1, (1000, 900), (30, 25)),     # windows wider than one staged chunk
        (np.float32, 2, (333, 250), (160, 121)),
        (np.float32, 1, (2000, 1800), (40, 60)),   # f32 windows taller than a ring buffer
        (np.uint8, 2, (300, 260), (150, 130)),     # down by 2, uint8
        (np.float32, 2, (120, 100), (240, 200)),   # up by 2, f32
        (np.uint16, 3, (37, 23), (19, 50)),        # smaller than one tile, odd pitch
        (np.uint16, 400, (64, 64), (32, 32)),      # more tiles than the persistent CTAs
        (np.uint8, 1, (97, 61), (13, 7)),          # odd pitch, uint8
    ],
    ids=["down2", "odd", "up-u8", "down33", "f32", "down50-f32", "down2-u8", "up2-f32",
         "small", "many", "odd-u8"],
)
def test_lanczos_kernel(cuda, dtype, batch, in_shape, out_shape):
    """K7: the f32 sums to 1e-5 of each output's sum of |w * x|; integer
    results after PIL's rounding within 1 unit."""
    from saguaro_tpu_torch.kernels import resample as rs

    rng = np.random.default_rng(11)
    if dtype == np.float32:
        host = rng.normal(0.0, 500.0, (batch,) + in_shape).astype(dtype)
    else:
        host = rng.integers(0, np.iinfo(dtype).max, (batch,) + in_shape).astype(dtype)
    imgs = torch.from_numpy(host).to(cuda)
    before = sc.LAUNCHES["lanczos_resize"]
    got = rs.lanczos_resample(imgs, out_shape)
    torch.cuda.synchronize()
    assert sc.LAUNCHES["lanczos_resize"] == before + 1
    want = rs.resize_plain(imgs, out_shape, dtype=torch.float64)
    scale = rs.resize_plain(imgs, out_shape, magnitude=True, dtype=torch.float64)
    assert got.shape == (batch,) + out_shape and got.dtype == torch.float32
    assert torch.all((got.double() - want).abs() <= 1e-5 * scale + 1e-6)
    if dtype != np.float32:
        cast = rs.lanczos_resize_batch(imgs, out_shape)
        plain = rs._cast(rs.resize_plain(imgs, out_shape), imgs.dtype)
        assert cast.dtype == imgs.dtype
        assert int((cast.to(torch.int32) - plain.to(torch.int32)).abs().max()) <= 1


def _granularity_planes(kind, b, h, w, seed=0):
    """(b, h, w) f32 background-removed planes on the host: ``blobs`` from
    ``blob_sites`` (sites x channels of 4h x 4w, through
    ``granularity_pixels``), else random grey levels rounded to plateaus."""
    from saguaro_tpu_torch.kernels.morphology import granularity_pixels

    if kind == "blobs":
        img, _ = blob_sites(n_sites=b // 5, h=4 * h, w=4 * w, n_ch=5, n_cells=80, seed=seed)
        planes = torch.from_numpy(np.ascontiguousarray(np.moveaxis(img, -1, 1).reshape(b, 4 * h, 4 * w)))
        return granularity_pixels(planes)
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.round(rng.random((b, h, w)) * 40).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,b,h,w", [("blobs", 40, 270, 270), ("plateaus", 1, 1, 1),
                                         ("plateaus", 1, 17, 300), ("plateaus", 3, 541, 541)])
def test_granularity_kernel(cuda, kind, b, h, w):
    """K8 against the plain form on the card: the spectrum within rtol 1e-5
    (atol 1e-6), two calls bit for bit the same, one launch a call."""
    from saguaro_tpu_torch.kernels.morphology import granularity_scales_plain

    px = _granularity_planes(kind, b, h, w).to(cuda)
    before = sc.LAUNCHES["sag_granularity"]
    got = sc.sag_granularity(px, 16)
    again = sc.sag_granularity(px, 16)
    torch.cuda.synchronize()
    assert sc.LAUNCHES["sag_granularity"] == before + 2
    want = granularity_scales_plain(px, 16)
    assert got.shape == (b, 16) and got.dtype == torch.float32
    assert torch.equal(got, again)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    if kind == "blobs":
        assert float(want.abs().max()) > 1.0


@pytest.mark.cuda
def test_granularity_kernel_refuses_what_it_does_not_take(cuda):
    px = _granularity_planes("plateaus", 2, 40, 50).to(cuda)
    for bad in (px.cpu(), px.double(), px.transpose(1, 2)):
        with pytest.raises(ValueError):
            sc.sag_granularity(bad, 16)


@pytest.mark.cuda
def test_granularity_kernel_counts_for_a_recorder_only(cuda):
    """With a recorder open the kernel's rounds are fetched once (one wait,
    at least one grid round a scale); without one there is no read and no
    wait record, and the launch is the profiler's one ``sag/`` op."""
    from saguaro_tpu_torch.utils import timing

    px = _granularity_planes("plateaus", 3, 90, 70).to(cuda)
    rec = timing.StageTimer()
    with rec.recording(cuda, launches=sc.LAUNCHES):
        with timing.span("measure/granularity"):
            sc.sag_granularity(px, 16)
    assert rec.counters["waits/granularity"] == 1
    assert rec.counters["rounds/granularity.grid"] >= 16
    assert rec.counters["rounds/granularity.tile"] >= 4 * rec.counters["rounds/granularity.grid"]
    assert rec.counters["launches/sag_granularity"] == 1
    assert [r.name for r in rec.rows if r.kind == "wait"] == ["measure/granularity/wait"]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with timing.span("measure/granularity"):
            sc.sag_granularity(px, 16)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    assert not [n for n in names if n.endswith("/wait")]
    assert names.count("sag/sag_granularity") == 1
