"""Hopper kernels K1-K4 of the measurement stage, their bindings and plain twins.

Each CUDA kernel under ``saguaro_tpu_torch/csrc/`` replaces one Pallas
kernel of ``saguaro_tpu/kernels/segment_pallas.py``:

* K1 ``seg_counts``      fused per-label histograms     (``seg_counts_pallas``)
* K2 ``seg_take_t``      per-pixel table gather, (K, N)  (``seg_take_t_pallas``)
* K3 ``seg_sums``        per-label sums of value lanes   (``seg_sums_pallas``)
* K4 ``seg_lane_sums_a`` / ``seg_lane_sums_c``
                         per-label sums of lanes built in registers by the
                         measurement's pass A / pass C lane functions
                         (``seg_lane_sums_pallas``)

Every kernel takes a leading site-batch dimension, so one launch covers a
batch. The sources are compiled at first use by one ``nvcc`` call into a
shared library with a plain C interface (``_build/``, git-ignored) and
bound with ``ctypes``. Each wrapper checks device, dtype, shape and
contiguity, allocates its output with torch, launches on the current CUDA
stream, raises when the launch reports an error, and counts its launches
in ``LAUNCHES``. A wrapper given a tensor that is not on a CUDA device
raises; the ``*_plain`` function beside it computes the same result with
PyTorch operations and is what CPU tensors get (``onehot_reduce`` and
``fused_measure`` dispatch by the tensor's device).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from saguaro_tpu_torch.kernels.zernike import ZERNIKE_INDEXES

__all__ = [
    "LAUNCHES",
    "reset_launch_counts",
    "build_kernels",
    "seg_counts",
    "counts_plain",
    "seg_take_t",
    "take_t_plain",
    "seg_sums",
    "sums_plain",
    "seg_lane_sums_a",
    "lane_sums_a_plain",
    "seg_lane_sums_c",
    "lane_sums_c_plain",
    "n_lanes_a",
    "n_lanes_c",
    "table_cols_c",
]

_PKG = Path(__file__).resolve().parents[1]
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
_SOURCES = ("common.cuh", "counts.cu", "take.cu", "sums.cu", "lane_sums.cu", "errors.cu")
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_MAX_CH = 8  # SAG_MAX_CH in lane_sums.cu

# launches of each kernel since the last reset (one per wrapper launch)
LAUNCHES: dict[str, int] = {
    "seg_counts": 0,
    "seg_take_t": 0,
    "seg_sums": 0,
    "seg_lane_sums_a": 0,
    "seg_lane_sums_c": 0,
}

_LIB: ctypes.CDLL | None = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# build and bind


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the CUDA toolkit")


def build_kernels() -> Path:
    """Compile ``csrc/*.cu`` into ``_build/libsaguaro_seg_<hash>.so`` unless a
    library built from the same sources and flags is already there. The
    compiler's register/shared-memory report goes to ``_build/build.log``."""
    digest = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for name in _SOURCES:
        digest.update((_CSRC / name).read_bytes())
    lib = _BUILD / f"libsaguaro_seg_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    _BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", tmp] + [
        str(_CSRC / n) for n in _SOURCES if n.endswith(".cu")
    ]
    res = subprocess.run(cmd, capture_output=True, text=True)
    (_BUILD / "build.log").write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr[-4000:]}")
    os.replace(tmp, lib)
    return lib


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build_kernels()))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        sigs = {
            "sag_counts": (p, p, p, p, i, ll, i, i, i, p),
            "sag_take_t": (p, p, p, i, ll, i, i, p),
            "sag_sums": (p, p, p, i, ll, i, i, p),
            "sag_lanes_a": (p, p, p, p, p, i, i, i, i, i, i, i, p),
            "sag_lanes_c": (p, p, p, p, i, p, p, i, i, i, i, i, i, i, i, i, p),
        }
        for name, args in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = list(args)
            fn.restype = ctypes.c_int
        lib.sag_error_string.argtypes = [ctypes.c_int]
        lib.sag_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor (got {t.device}); CPU tensors take the plain form")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype} (got {t.dtype})")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims (got shape {tuple(t.shape)})")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(fn_name: str, counter: str, device: torch.device, *args) -> None:
    lib = _lib()
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = getattr(lib, fn_name)(*args, stream)
    if rc != 0:
        msg = lib.sag_error_string(rc).decode()
        raise RuntimeError(f"{fn_name} failed: CUDA error {rc} ({msg})")
    LAUNCHES[counter] += 1


# ---------------------------------------------------------------------------
# K1: fused per-label histograms


def _plan(sizes: tuple[int, ...]) -> tuple[list[int], int]:
    offs, total = [], 0
    for n in sizes:
        offs.append(total)
        total += n
    return offs, total


def seg_counts(
    labels: torch.Tensor, codes: torch.Tensor, sizes: tuple[int, ...], max_cells: int
) -> torch.Tensor:
    """labels (B, N) int32 + codes (B, Q, N) int32 (code -1 = invalid pixel,
    plane q's codes in [0, sizes[q])) -> (B, max_cells, sum(sizes)) f32 of
    exact counts, plane q in columns [off_q, off_q + sizes[q])."""
    _check(labels, "labels", torch.int32, 2)
    _check(codes, "codes", torch.int32, 3)
    b, n = labels.shape
    q = codes.shape[1]
    if codes.shape != (b, q, n) or len(sizes) != q:
        raise ValueError(f"codes {tuple(codes.shape)} do not match labels {(b, n)} and sizes {sizes}")
    offs, total = _plan(tuple(sizes))
    plan = torch.tensor(offs + list(sizes), dtype=torch.int32, device=labels.device)
    out = torch.zeros((b, max_cells, total), dtype=torch.int32, device=labels.device)
    _launch(
        "sag_counts", "seg_counts", labels.device,
        labels.data_ptr(), codes.data_ptr(), plan.data_ptr(), out.data_ptr(),
        b, n, q, max_cells, total,
    )
    return out.float()


def counts_plain(
    labels: torch.Tensor, codes: torch.Tensor, sizes: tuple[int, ...], max_cells: int
) -> torch.Tensor:
    """Plain PyTorch form of ``seg_counts`` (bincount over combined keys)."""
    b, q, n = codes.shape
    offs, total = _plan(tuple(sizes))
    size = b * max_cells * total
    lab = labels.long()
    lab_ok = (lab >= 0) & (lab < max_cells)
    site = torch.arange(b, device=labels.device)[:, None] * (max_cells * total)
    out = torch.zeros(size + 1, dtype=torch.int64, device=labels.device)
    for k in range(q):
        c = codes[:, k].long()
        ok = lab_ok & (c >= 0) & (c < sizes[k])
        key = torch.where(ok, site + lab * total + offs[k] + c, size)
        out += torch.bincount(key.reshape(-1), minlength=size + 1)
    return out[:size].view(b, max_cells, total).float()


# ---------------------------------------------------------------------------
# K2: per-pixel gather of a per-label table, transposed


def seg_take_t(table: torch.Tensor, seg: torch.Tensor, max_cells: int) -> torch.Tensor:
    """(B, max_cells, K) f32 table + (B, N) int32 labels -> (B, K, N) f32:
    ``table[b, seg[b, i], k]`` with non-finite and >= 3.38e38 entries read
    as 0 and labels outside [0, max_cells) giving 0."""
    _check(table, "table", torch.float32, 3)
    _check(seg, "seg", torch.int32, 2)
    b, n = seg.shape
    if table.shape[:2] != (b, max_cells):
        raise ValueError(f"table {tuple(table.shape)} is not (B={b}, max_cells={max_cells}, K)")
    k = table.shape[2]
    out = torch.empty((b, k, n), dtype=torch.float32, device=seg.device)
    _launch(
        "sag_take_t", "seg_take_t", seg.device,
        table.data_ptr(), seg.data_ptr(), out.data_ptr(), b, n, max_cells, k,
    )
    return out


def clean_table(table: torch.Tensor) -> torch.Tensor:
    """K2's sentinel rule: non-finite entries and entries of magnitude
    >= 3.38e38 (the empty-label min/max sentinel) read as 0."""
    t = table.float()
    return torch.where(torch.isfinite(t) & (t.abs() < 3.38e38), t, torch.zeros_like(t))


def take_t_plain(table: torch.Tensor, seg: torch.Tensor, max_cells: int) -> torch.Tensor:
    """Plain PyTorch form of ``seg_take_t`` (an indexed gather)."""
    t = clean_table(table)
    b, n = seg.shape
    k = t.shape[2]
    lab = seg.long()
    ok = (lab >= 0) & (lab < max_cells)
    g = torch.gather(t, 1, lab.clamp(0, max_cells - 1)[..., None].expand(b, n, k))
    g = torch.where(ok[..., None], g, torch.zeros_like(g))
    return g.transpose(1, 2).contiguous()


# ---------------------------------------------------------------------------
# K3: per-label sums


def seg_sums(labels: torch.Tensor, values: torch.Tensor, max_cells: int) -> torch.Tensor:
    """(B, N) int32 labels + (B, N, K) f32 values -> (B, max_cells, K) f32
    per-label sums (labels outside [0, max_cells) are dropped)."""
    _check(labels, "labels", torch.int32, 2)
    _check(values, "values", torch.float32, 3)
    b, n = labels.shape
    if values.shape[:2] != (b, n):
        raise ValueError(f"values {tuple(values.shape)} do not match labels {(b, n)}")
    k = values.shape[2]
    out = torch.zeros((b, max_cells, k), dtype=torch.float32, device=labels.device)
    _launch(
        "sag_sums", "seg_sums", labels.device,
        labels.data_ptr(), values.data_ptr(), out.data_ptr(), b, n, k, max_cells,
    )
    return out


def sums_plain(labels: torch.Tensor, values: torch.Tensor, max_cells: int) -> torch.Tensor:
    """Plain PyTorch form of ``seg_sums`` (``index_add_`` into label rows)."""
    b, n = labels.shape
    k = values.shape[2]
    lab = labels.long()
    ok = (lab >= 0) & (lab < max_cells)
    site = torch.arange(b, device=labels.device)[:, None] * max_cells
    idx = torch.where(ok, site + lab, b * max_cells).reshape(-1)
    out = torch.zeros((b * max_cells + 1, k), dtype=torch.float32, device=labels.device)
    out.index_add_(0, idx, values.reshape(b * n, k).float())
    return out[: b * max_cells].view(b, max_cells, k)


# ---------------------------------------------------------------------------
# K4: fused lane scans (measurement passes A and C)


def _pairs(n_ch: int) -> list[tuple[int, int]]:
    return [(a, b) for a in range(n_ch) for b in range(a + 1, n_ch)]


def n_lanes_a(n_ch: int, with_edge: bool) -> int:
    return 5 + 4 * n_ch + len(_pairs(n_ch)) + (n_ch if with_edge else 0)


def n_lanes_c(n_ch: int, with_moments: bool, with_zernike: bool, with_edge: bool) -> int:
    return (
        15 + (15 if with_moments else 0) + (60 if with_zernike else 0)
        + n_ch + len(_pairs(n_ch)) + (n_ch if with_edge else 0)
    )


def table_cols_c(n_ch: int, with_moments: bool, with_zernike: bool, with_edge: bool) -> int:
    """Columns of pass C's per-label table: cy, cx, [ymin, xmin], [rmax],
    mean (C), [edge mean (C)]."""
    return 2 + (2 if with_moments else 0) + (1 if with_zernike else 0) + n_ch + (
        n_ch if with_edge else 0
    )


def _check_lane_inputs(labels, image, border, max_cells):
    _check(labels, "labels", torch.int32, 3)
    _check(image, "image", torch.float32, 4)
    _check(border, "border", torch.uint8, 3)
    b, h, w = labels.shape
    n_ch = image.shape[3]
    if image.shape[:3] != (b, h, w) or border.shape != (b, h, w):
        raise ValueError("labels, image and border must share (B, H, W)")
    if not 1 <= n_ch <= _MAX_CH:
        raise ValueError(f"the lane kernels take 1..{_MAX_CH} channels, got {n_ch}")
    if max_cells * 4 > 96 * 1024:
        raise ValueError(f"max_cells={max_cells} exceeds the lane kernels' shared accumulator")
    return b, h, w, n_ch


def seg_lane_sums_a(
    labels: torch.Tensor,
    image: torch.Tensor,
    pweight: torch.Tensor,
    border: torch.Tensor,
    max_cells: int,
    with_edge: bool,
) -> torch.Tensor:
    """Pass A sums. labels (B, H, W) int32 (raw ids; ids >= max_cells fold
    into slot 0), image (B, H, W, C) f32, pweight (B, H, W) f32 perimeter
    weights, border (B, H, W) uint8 -> (B, max_cells, n_lanes_a) f32."""
    b, h, w, n_ch = _check_lane_inputs(labels, image, border, max_cells)
    _check(pweight, "pweight", torch.float32, 3)
    nl = n_lanes_a(n_ch, with_edge)
    out = torch.zeros((b, max_cells, nl), dtype=torch.float32, device=labels.device)
    _launch(
        "sag_lanes_a", "seg_lane_sums_a", labels.device,
        labels.data_ptr(), image.data_ptr(), pweight.data_ptr(), border.data_ptr(),
        out.data_ptr(), b, h, w, n_ch, max_cells, int(with_edge), nl,
    )
    return out


def seg_lane_sums_c(
    labels: torch.Tensor,
    image: torch.Tensor,
    border: torch.Tensor,
    table: torch.Tensor,
    zcoef: torch.Tensor,
    max_cells: int,
    with_moments: bool,
    with_zernike: bool,
    with_edge: bool,
) -> torch.Tensor:
    """Pass C sums. table (B, max_cells, table_cols_c) f32 per-label values
    gathered per pixel (sentinel entries read as 0); zcoef (30, 10) f32
    Zernike radial coefficients -> (B, max_cells, n_lanes_c) f32."""
    b, h, w, n_ch = _check_lane_inputs(labels, image, border, max_cells)
    _check(table, "table", torch.float32, 3)
    _check(zcoef, "zcoef", torch.float32, 2)
    k_tab = table_cols_c(n_ch, with_moments, with_zernike, with_edge)
    if table.shape != (b, max_cells, k_tab) or zcoef.shape != (30, 10):
        raise ValueError(f"table {tuple(table.shape)} != {(b, max_cells, k_tab)} or bad zcoef")
    nl = n_lanes_c(n_ch, with_moments, with_zernike, with_edge)
    out = torch.zeros((b, max_cells, nl), dtype=torch.float32, device=labels.device)
    _launch(
        "sag_lanes_c", "seg_lane_sums_c", labels.device,
        labels.data_ptr(), image.data_ptr(), border.data_ptr(), table.data_ptr(), k_tab,
        zcoef.data_ptr(), out.data_ptr(), b, h, w, n_ch, max_cells,
        int(with_moments), int(with_zernike), int(with_edge), nl,
    )
    return out


def _lanes_a(y, x, inside, bnd, pw, vr, with_edge: bool) -> torch.Tensor:
    """Pass A lanes of P pixels: y, x, inside, bnd, pw (P,), vr (P, C) ->
    (P, n_lanes_a), the column order of fused_measure's lanes_a_fn."""
    v = vr * inside[:, None]
    cols = [inside[:, None], (y * inside)[:, None], (x * inside)[:, None],
            bnd[:, None], pw[:, None], v, y[:, None] * v, x[:, None] * v]
    if with_edge:
        cols.append(vr * bnd[:, None])
    cols.append(vr * v)
    pairs = _pairs(vr.shape[1])
    if pairs:
        cols.append(torch.stack([vr[:, a] * v[:, b] for a, b in pairs], dim=1))
    return torch.cat(cols, dim=1)


def _lanes_c(y, x, inside, bnd, vr, g, zcoef, with_moments, with_zernike, with_edge,
             magnitude=False):
    """Pass C lanes of P pixels given their gathered table rows g (P, K) ->
    (P, n_lanes_c), the column order of fused_measure's lanes_c_fn. cos/sin
    of m*theta come from the angle-addition recurrence on (dx, dy)/dist,
    as in the Pallas lane function. ``magnitude=True`` gives each lane's
    rounding scale instead: |lane|, and for the Zernike lanes
    sum_k |coef_k| rho^k, the size of the terms the radial polynomial
    cancels (its value can be far smaller)."""
    n_ch = vr.shape[1]
    o_rmax = 2 + (2 if with_moments else 0)
    o_mean = o_rmax + (1 if with_zernike else 0)
    o_emean = o_mean + n_ch
    dy = y - g[:, 0]
    dx = x - g[:, 1]

    def powers(base):
        b2 = base * base
        return [inside, base, b2, b2 * base]

    orders = [(p, q) for p in range(4) for q in range(4) if (p, q) != (0, 0)]
    ycp, xcp = powers(dy * inside), powers(dx * inside)
    cols = [ycp[p] * xcp[q] for p, q in orders]
    if with_moments:
        ybp = powers((y - g[:, 2]) * inside)
        xbp = powers((x - g[:, 3]) * inside)
        cols += [ybp[p] * xbp[q] for p, q in orders]
    cols = [torch.stack(cols, dim=1)]
    if with_zernike:
        dist = torch.sqrt(dy * dy + dx * dx)
        inv_rmax = 1.0 / torch.clamp(g[:, o_rmax], min=1e-6)
        rho = torch.clamp(dist * inv_rmax, max=1.0)
        rp = [torch.ones_like(rho)]
        for _ in range(9):
            rp.append(rp[-1] * rho)
        radials = torch.stack(rp, dim=1) @ (zcoef.abs() if magnitude else zcoef).T  # (P, 30)
        inv_d = torch.where(dist > 0.0, 1.0 / torch.clamp(dist, min=1e-30), torch.zeros_like(dist))
        ct, st = dx * inv_d, dy * inv_d
        cms, sms = [torch.ones_like(ct)], [torch.zeros_like(ct)]
        for _ in range(1, 10):
            c_new = ct * cms[-1] - st * sms[-1]
            s_new = st * cms[-1] + ct * sms[-1]
            cms.append(c_new)
            sms.append(s_new)
        ms = [m for _, m in ZERNIKE_INDEXES]
        if magnitude:
            cols += [radials * inside[:, None]] * 2
        else:
            cols.append(radials * torch.stack([cms[m] for m in ms], dim=1) * inside[:, None])
            cols.append(radials * torch.stack([sms[m] for m in ms], dim=1) * inside[:, None])
    vc = (vr - g[:, o_mean : o_mean + n_ch]) * inside[:, None]
    cols.append(vc * vc)
    pairs = _pairs(n_ch)
    if pairs:
        cols.append(torch.stack([vc[:, a] * vc[:, b] for a, b in pairs], dim=1))
    if with_edge:
        ec = (vr - g[:, o_emean : o_emean + n_ch]) * bnd[:, None]
        cols.append(ec * ec)
    lanes = torch.cat(cols, dim=1)
    return lanes.abs() if magnitude else lanes


def _lane_sums_plain(labels, image, border, max_cells, n_lanes, build, dtype, chunk=1 << 20):
    """Chunked plain lane scan in ``dtype``: build each chunk's lanes,
    ``index_add_`` them into (B * max_cells) label rows. ``build(sl, y, x,
    inside, bnd, vr, rows)`` returns the (P, n_lanes) lanes of flat pixels
    ``sl``."""
    b, h, w = labels.shape
    n = b * h * w
    raw = labels.reshape(-1).long()
    img = image.reshape(n, image.shape[3]).to(dtype)
    bnd_all = border.reshape(-1).to(dtype)
    site = torch.arange(b, device=labels.device).repeat_interleave(h * w) * max_cells
    out = torch.zeros((b * max_cells, n_lanes), dtype=dtype, device=labels.device)
    for s in range(0, n, chunk):
        sl = slice(s, min(s + chunk, n))
        r = raw[sl]
        pix = torch.arange(sl.start, sl.stop, device=labels.device) % (h * w)
        y = torch.div(pix, w, rounding_mode="floor").to(dtype)
        x = (pix % w).to(dtype)
        inside = (r > 0).to(dtype)
        slot = torch.where((r > 0) & (r < max_cells), r, torch.zeros_like(r))
        rows = site[sl] + slot
        out.index_add_(0, rows, build(sl, y, x, inside, bnd_all[sl], img[sl], rows))
    return out.view(b, max_cells, n_lanes)


def lane_sums_a_plain(
    labels, image, pweight, border, max_cells, with_edge, magnitude=False, dtype=torch.float32
):
    """Plain PyTorch form of ``seg_lane_sums_a``, summed in ``dtype``.
    ``magnitude=True`` sums |lane| instead: the scale against which two
    summation orders of the same lanes are compared."""
    n_ch = image.shape[3]
    pw_all = pweight.reshape(-1).to(dtype)

    def build(sl, y, x, inside, bnd, vr, rows):
        lanes = _lanes_a(y, x, inside, bnd, pw_all[sl], vr, with_edge)
        return lanes.abs() if magnitude else lanes

    nl = n_lanes_a(n_ch, with_edge)
    return _lane_sums_plain(labels, image, border, max_cells, nl, build, dtype)


def lane_sums_c_plain(
    labels, image, border, table, zcoef, max_cells, with_moments, with_zernike, with_edge,
    magnitude=False, dtype=torch.float32,
):
    """Plain PyTorch form of ``seg_lane_sums_c``, summed in ``dtype``.
    ``magnitude=True`` sums each lane's rounding scale (see ``_lanes_c``)."""
    n_ch = image.shape[3]
    tab = clean_table(table).reshape(-1, table.shape[2]).to(dtype)
    zc = zcoef.to(dtype)

    def build(sl, y, x, inside, bnd, vr, rows):
        return _lanes_c(
            y, x, inside, bnd, vr, tab[rows], zc, with_moments, with_zernike, with_edge, magnitude
        )

    nl = n_lanes_c(n_ch, with_moments, with_zernike, with_edge)
    return _lane_sums_plain(labels, image, border, max_cells, nl, build, dtype)
