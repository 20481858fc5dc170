"""Hopper kernels K1-K6 of the measurement stage, their bindings and plain twins,
and the build and launch helpers that K7 (``kernels/resample_cuda``) shares.

Each CUDA kernel under ``saguaro_tpu_torch/csrc/`` replaces one Pallas
kernel of ``saguaro_tpu/kernels/segment_pallas.py``:

* K1 ``seg_counts``      fused per-label histograms     (``seg_counts_pallas``)
* K2 ``seg_take_t``      per-pixel table gather, (K, N)  (``seg_take_t_pallas``)
* K3 ``seg_sums``        per-label sums of value lanes   (``seg_sums_pallas``)
* K4 ``seg_lane_sums_a`` / ``seg_lane_sums_c`` / ``seg_lane_sums_e``
                         per-label sums of lanes built in registers by the
                         measurement's pass A / pass C / colocalization
                         pass E lane functions (``seg_lane_sums_pallas``)
     ``seg_radial_sums`` the radial lanes of pass C, as per-(label, bin)
                         counts and channel sums
* K5 ``seg_edt_sweep``   bounded horizontal EDT sweep    (``edt_sweep_pallas``)
* K6 ``seg_pick2``       per-pixel two-level table pick  (``pick2_pallas``)

K7, the Lanczos re-binner of the pixel stages (``csrc/lanczos.cu``), is
built into the same library and counted here as ``lanczos_resize``. K8
``sag_granularity`` (``csrc/granularity.cu``) replaces no Pallas kernel:
it runs every scale of the granularity spectrum's reconstructions, which
the reference leaves to an XLA ``while_loop``, in one cooperative launch;
its plain form is ``morphology.granularity_scales_plain``.

Every kernel takes a leading site-batch dimension, so one launch covers a
batch. The sources are compiled at first use, one ``nvcc`` a source in
parallel, into a shared library with a plain C interface (``_build/``,
git-ignored) and bound with ``ctypes``. Each wrapper checks device, dtype, shape and
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
from dataclasses import dataclass
from functools import lru_cache
from pathlib import Path

import torch

from saguaro_tpu_torch.device import on_device
from saguaro_tpu_torch.kernels.zernike import ZERNIKE_INDEXES
from saguaro_tpu_torch.utils import timing

__all__ = [
    "LAUNCHES",
    "reset_launch_counts",
    "build_kernels",
    "seg_counts",
    "counts_plain",
    "counts_plan",
    "CountsPlan",
    "counts_kernel_info",
    "seg_take_t",
    "take_t_plain",
    "seg_sums",
    "sums_plain",
    "sums_plan",
    "sums_card_plan",
    "sums_width",
    "SumsPlan",
    "sums_kernel_info",
    "seg_lane_sums_a",
    "lane_sums_a_plain",
    "seg_lane_sums_c",
    "lane_sums_c_plain",
    "seg_lane_sums_e",
    "lane_sums_e_plain",
    "seg_radial_sums",
    "radial_sums_plain",
    "radial_plan",
    "radial_card_plan",
    "RadialPlan",
    "radial_kernel_info",
    "seg_edt_sweep",
    "edt_sweep_plain",
    "edt_geometry",
    "EdtGeometry",
    "edt_kernel_info",
    "seg_pick2",
    "pick2_plain",
    "pick2_plan",
    "pick2_out",
    "Pick2Plan",
    "pick2_kernel_info",
    "n_lanes_a",
    "n_lanes_c",
    "table_cols_c",
    "lanes_kernel_info",
    "sag_granularity",
    "granularity_kernel_info",
]

_PKG = Path(__file__).resolve().parents[1]
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
_SOURCES = (
    "common.cuh", "counts.cu", "take.cu", "sums.cu", "lane_sums.cu", "radial_sums.cu",
    "edt_sweep.cu", "pick2.cu", "lanczos.cu", "granularity.cu", "errors.cu",
)
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_MAX_CH = 8  # SAG_MAX_CH in lane_sums.cu

# launches of each kernel since the last reset (one per wrapper launch)
LAUNCHES: dict[str, int] = {
    "seg_counts": 0,
    "seg_take_t": 0,
    "seg_sums": 0,
    "seg_lane_sums_a": 0,
    "seg_lane_sums_c": 0,
    "seg_lane_sums_e": 0,
    "seg_radial_sums": 0,
    "seg_edt_sweep": 0,
    "seg_pick2": 0,
    "lanczos_resize": 0,
    "sag_granularity": 0,
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
    library built from the same sources and flags is already there: one
    ``nvcc -c`` a source, all started together, then one link. The
    compilers' register/shared-memory reports go to ``_build/build.log``."""
    digest = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for name in _SOURCES:
        digest.update((_CSRC / name).read_bytes())
    lib = _BUILD / f"libsaguaro_seg_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    _BUILD.mkdir(parents=True, exist_ok=True)
    objs = Path(tempfile.mkdtemp(dir=_BUILD))
    try:
        procs = [
            (n, subprocess.Popen([_nvcc(), *_NVCC_FLAGS, "-c", "-o", str(objs / f"{n}.o"),
                                  str(_CSRC / n)], stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True))
            for n in _SOURCES if n.endswith(".cu")
        ]
        logs = [(n, p.communicate()[0], p.returncode) for n, p in procs]
        (_BUILD / "build.log").write_text("".join(f"== {n}\n{out}" for n, out, _ in logs))
        failed = [f"{n}:\n{out[-3000:]}" for n, out, rc in logs if rc != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp = objs / "lib.so"
        res = subprocess.run([_nvcc(), "-shared", "-o", str(tmp),
                              *(str(objs / f"{n}.o") for n, _, _ in logs)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stderr[-4000:]}")
        os.replace(tmp, lib)
    finally:
        shutil.rmtree(objs, ignore_errors=True)
    return lib


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# argument types of the library's C entry points (each returns an int status)
SIGNATURES = {
    "sag_counts": (_P, _P, _P, _P, _I, _LL) + (_I,) * 11 + (_P,),
    "sag_counts_info": (_I, _I, _P),
    "sag_take_t": (_P, _P, _P, _I, _LL, _I, _I, _P),
    "sag_sums": (_P, _P, _P, _I, _LL, _I, _I, _I, _I, _I, _LL, _P),
    "sag_sums_info": (_I, _I, _P),
    "sag_lanes_a": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "sag_lanes_c": (_P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "sag_lanes_e": (_P, _P, _P, _P, _P, _P, _I, _LL, _I, _I, _I, _P),
    "sag_lanes_info": (_I, _I, _I, _P),
    "sag_radial_sums": (_P, _P, _P, _P, _I, _LL, _I, _I, _I, _I, _LL, _P),
    "sag_radial_info": (_I, _P),
    "sag_edt_sweep": (_P, _P, _P, _I, _I, _I, _I, _P),
    "sag_edt_sweep_info": (_I, _I, _I, _P),
    "sag_pick2": (_P, _P, _P, _P, _I, _LL, _I, _I, _LL, _I, _I, _P),
    "sag_pick2_info": (_I, _P),
    "sag_lanczos": (_P, _I, _P, _P, _P, _I, _I, _P, _P, _I, _I, _P, _P) + (_I,) * 9 + (_P,),
    "sag_lanczos_info": (_I, _I, _I, _P),
    "sag_granularity": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "sag_granularity_info": (_I, _I, _I, _P),
}


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build_kernels()))
        for name, args in SIGNATURES.items():
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
    """Calls ``fn_name`` of the library on ``device``'s current stream and
    counts the launch. Under a running torch.profiler the call is an op of
    its own, ``sag/<counter>``: the profiler links a kernel to the op whose
    correlation id the launch carries, which only an op (a FUNCTION-scope
    record, as PyTorch's own launches and Triton's have) pushes, not a
    ``record_function`` range. Without a profiler the record is a no-op.

    The C call launches on the thread's current CUDA device, so ``device``
    is made current around it: a shard on another card than the current
    one launches there."""
    lib = _lib()
    with on_device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        with torch._C._profiler._RecordFunctionFast(f"sag/{counter}"):
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


# K1's launch plan (csrc/counts.cu). A CTA holds a slice of at most
# K1_SLICE bytes of the (max_cells x columns) int32 table in shared memory;
# a larger table is cut into row tiles (one CTA each, reading the same
# pixels) or split over a thread-block cluster's distributed shared memory.
K1_THREADS = 512                # SAG_COUNTS_THREADS in counts.cu
K1_SLICE = 200 * 1024           # bytes of table a CTA holds
K1_COPIES_BYTES = 32 * 1024     # per-warp copies of a small table: at most this much
K1_SMEM_SM = 228 * 1024         # shared memory of an SM (1 KB of it reserved per CTA)
K1_THREADS_SM = 1024            # resident threads of an SM the plan counts on
K1_MAX_CLUSTER = 8              # the largest (portable) cluster Hopper runs
K1_MIN_PIXELS = K1_THREADS * 8 * 4  # pixels a CTA takes at least (4 octets a thread)
K1_SMS = 132                    # SMs of an H100 SXM
K1_CLUSTER_RATIO = 4            # a cluster, not row tiles, past this many tiles a plane
K1_WAVES = 4                    # waves of resident CTAs a call aims at


@dataclass(frozen=True)
class CountsPlan:
    """K1's launch plan. ``groups`` of (q0, q1, col0, col1): the planes [q0,
    q1) whose columns meet the group's columns [col0, col1) of the
    (max_cells, sum(sizes)) table. In each group the label rows are cut in
    ``rows``-row slices, one a CTA: over ``tiles`` CTAs that each read the
    same pixels and count their own rows' keys (``cluster`` 1), or over the
    ``cluster`` CTAs of a thread-block cluster that each read their own
    pixels and add every key into its owner's shared memory (``tiles`` 1).
    ``copies``: per-warp copies of a one-slice table; ``units``: pixel
    units of each (group, site), a unit being a set of ``tiles`` CTAs or
    one cluster; ``smem``: dynamic shared bytes a CTA."""

    cluster: int
    rows: int
    tiles: int
    groups: tuple[tuple[int, int, int, int], ...]
    copies: int
    units: int
    smem: int

    @property
    def path(self) -> str:
        if self.cluster > 1:
            return "cluster"
        return "shared" if self.tiles == 1 else "tiles"

    @property
    def ways(self) -> int:
        """CTAs that split a group's rows."""
        return max(self.cluster, self.tiles)

    @property
    def max_cols(self) -> int:
        return max(c1 - c0 for _, _, c0, c1 in self.groups)


def _column_groups(sizes, offs, cols_max):
    """Column ranges of at most cols_max columns: whole planes packed in
    order while they fit, a plane wider than cols_max cut into equal pieces
    of its own."""
    groups, start, end = [], None, None
    for off, size in zip(offs, sizes):
        if size > cols_max:
            if start is not None:
                groups.append((start, end))
                start = None
            pieces = -(-size // cols_max)
            step = -(-size // pieces)
            groups += [(c, min(c + step, off + size)) for c in range(off, off + size, step)]
        elif start is not None and off + size - start <= cols_max:
            end = off + size
        else:
            if start is not None:
                groups.append((start, end))
            start, end = off, off + size
    if start is not None:
        groups.append((start, end))
    out = []
    for c0, c1 in groups:
        q0 = max(q for q, o in enumerate(offs) if o <= c0)
        q1 = max(q for q, o in enumerate(offs) if o < c1) + 1
        out.append((q0, q1, c0, c1))
    return out


def counts_plan(
    max_cells: int, sizes: tuple[int, ...], batch: int, n: int, n_sms: int = K1_SMS
) -> CountsPlan:
    """K1's launch plan for a (batch, n) call with code planes ``sizes``: a
    pure function of its arguments, fixed before the launch.

    A table of at most K1_SLICE bytes: one CTA holds it, in per-warp copies
    while they take at most K1_COPIES_BYTES. A larger one is cut into row
    tiles, slices of the whole width (column groups where one row is wider
    than a slice), one CTA each, unless the tiles would number more than
    K1_CLUSTER_RATIO a plane: then the smallest cluster (up to
    K1_MAX_CLUSTER CTAs) whose members' row slices hold the table, else
    clusters of K1_MAX_CLUSTER over column groups (the measured choice on an
    H100, PERF.md §6). ``units`` fills K1_WAVES waves of the card's resident
    CTAs (``n_sms`` SMs) over the (group, site) pairs, with at least
    K1_MIN_PIXELS pixels a CTA. Raises ValueError for a table that no plan
    holds."""
    sizes = tuple(int(s) for s in sizes)
    if max_cells < 1 or not sizes or min(sizes) < 1:
        raise ValueError(f"K1 needs max_cells >= 1 and code planes of >= 1 codes: {max_cells}, {sizes}")
    offs, total = _plan(sizes)
    if max_cells * total >= 2**31:
        raise ValueError(f"a {max_cells} x {total} table does not fit int32 keys")
    words = K1_SLICE // 4
    copies, cluster, tiles = 1, 1, 1
    whole = [(0, len(sizes), 0, total)]
    # row tiles each read every label of their pixels, a cluster reads them
    # once but sends most keys to another CTA: many tiles for few planes
    # take the cluster
    row_tiles = -(-max_cells // max(1, words // total))
    if max_cells * total <= words:
        rows, groups = max_cells, whole
        while copies * 2 <= K1_THREADS // 32 and 4 * max_cells * total * copies * 2 <= K1_COPIES_BYTES:
            copies *= 2
    elif row_tiles <= K1_CLUSTER_RATIO * len(sizes):
        groups = whole if total <= words else _column_groups(sizes, offs, words)
        rows = min(max_cells, words // max(c1 - c0 for _, _, c0, c1 in groups))
        tiles = -(-max_cells // rows)
        rows = -(-max_cells // tiles)
    else:
        fits = [c for c in range(2, K1_MAX_CLUSTER + 1) if -(-max_cells // c) * total <= words]
        cluster = fits[0] if fits else K1_MAX_CLUSTER
        rows = -(-max_cells // cluster)
        if rows > words:
            raise ValueError(f"K1 cannot hold {max_cells} label rows: {rows} rows a CTA exceed "
                             f"{K1_SLICE} B even at one column")
        groups = whole if fits else _column_groups(sizes, offs, words // rows)
    cols = max(c1 - c0 for _, _, c0, c1 in groups)
    smem = 4 * rows * cols * copies + 8 * len(sizes)
    per_sm = min(K1_THREADS_SM // K1_THREADS, K1_SMEM_SM // (smem + 1024))
    if per_sm < 1:
        raise ValueError(f"K1's plan needs {smem} B of shared memory a CTA")
    ways = max(cluster, tiles)
    per_unit = batch * len(groups) * ways
    # a cluster's CTAs split a unit's pixels; the tiles of a unit each read all of them
    by_size = -(-n // (cluster * K1_MIN_PIXELS))
    units = max(1, min(K1_WAVES * per_sm * n_sms // per_unit, by_size))
    if ways * units > 2**31 - 1 or len(groups) > 65535 or batch > 65535:
        raise ValueError(f"K1's grid ({ways * units}, {len(groups)}, {batch}) is too large")
    return CountsPlan(cluster, rows, tiles, tuple(groups), copies, units, smem)


_PLAN_TENSORS: dict[tuple, torch.Tensor] = {}


def _plan_tensor(sizes, plan: CountsPlan, device) -> torch.Tensor:
    """The plan's device array, cached: plane offsets, plane sizes, then
    (q0, q1, col0, col1) a group."""
    key = (str(device), sizes, plan.groups)
    t = _PLAN_TENSORS.get(key)
    if t is None:
        offs, _ = _plan(sizes)
        flat = offs + list(sizes) + [v for g in plan.groups for v in g]
        t = _PLAN_TENSORS[key] = torch.tensor(flat, dtype=torch.int32, device=device)
    return t


def seg_counts(
    labels: torch.Tensor, codes: torch.Tensor, sizes: tuple[int, ...], max_cells: int
) -> torch.Tensor:
    """labels (B, N) int32 + codes (B, Q, N) int16 (code -1 = invalid pixel,
    plane q's codes in [0, sizes[q])) -> (B, max_cells, sum(sizes)) f32 of
    exact counts, plane q in columns [off_q, off_q + sizes[q]). The launch
    follows ``counts_plan`` for this card's SMs and raises when the card
    cannot hold it."""
    _check(labels, "labels", torch.int32, 2)
    _check(codes, "codes", torch.int16, 3)
    b, n = labels.shape
    q = codes.shape[1]
    sizes = tuple(int(s) for s in sizes)
    if codes.shape != (b, q, n) or len(sizes) != q:
        raise ValueError(f"codes {tuple(codes.shape)} do not match labels {(b, n)} and sizes {sizes}")
    dev = labels.device
    plan = counts_plan(max_cells, sizes, b, n, torch.cuda.get_device_properties(dev).multi_processor_count)
    _, total = _plan(sizes)
    out = torch.zeros((b, max_cells, total), dtype=torch.int32, device=dev)
    _launch(
        "sag_counts", "seg_counts", dev,
        labels.data_ptr(), codes.data_ptr(), _plan_tensor(sizes, plan, dev).data_ptr(),
        out.data_ptr(), b, n, q, max_cells, total, len(plan.groups), plan.cluster, plan.rows,
        plan.tiles, plan.copies, plan.units, plan.max_cols, plan.smem,
    )
    return out.float()


def counts_kernel_info(plan: CountsPlan) -> dict[str, int]:
    """Resources of K1's kernel under ``plan`` on the current card:
    registers and local (spilled) bytes a thread, and how many fit at once:
    CTAs a SM for a one-CTA plan, clusters on the card for a cluster
    plan."""
    info = (ctypes.c_int * 3)()
    rc = _lib().sag_counts_info(plan.cluster, plan.smem, info)
    if rc != 0:
        raise RuntimeError(f"sag_counts_info failed: CUDA error {rc}")
    fits = "clusters_resident" if plan.cluster > 1 else "ctas_per_sm"
    return dict(zip(("registers", "local_bytes", fits), info))


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


# K3's launch plan (csrc/sums.cu). A CTA holds a (max_cells x width) f32
# table in shared memory and reads one contiguous range of a site's pixels,
# 4 a 16-byte vector.
K3_THREADS = 256                # K3_THREADS in sums.cu
K3_UNROLL = 2                   # K3_UNROLL in sums.cu: vectors a thread an iteration
K3_MAX_WIDTH = 4                # value lanes one launch takes (kernels for 1..4)
K3_TABLE_BYTES = 96 * 1024      # shared table a CTA at most
K3_MIN_VECS = K3_THREADS * K3_UNROLL  # vectors a CTA takes at least: one iteration


def sums_width(k_cols: int, max_cells: int) -> int:
    """Value lanes of one K3 launch: at most K3_MAX_WIDTH, with a
    (max_cells x width) f32 table of at most K3_TABLE_BYTES."""
    if max_cells < 1 or k_cols < 1:
        raise ValueError(f"K3 needs max_cells and value lanes >= 1: {max_cells}, {k_cols}")
    width = min(k_cols, K3_MAX_WIDTH, K3_TABLE_BYTES // (4 * max_cells))
    if width < 1:
        raise ValueError(f"K3 cannot hold {max_cells} labels: one lane's table exceeds "
                         f"{K3_TABLE_BYTES} B")
    return width


@dataclass(frozen=True)
class SumsPlan:
    """K3's launch plan: ``chunks`` of value lanes [c0, c1), one launch
    each (a chunk short of all lanes is copied out contiguous first);
    ``ctas`` CTAs a site, each over ``vecs`` 16-byte label vectors of the
    site's aligned pixels (the ragged head and tail of a site, at most 3
    pixels each, go to its first CTA)."""

    chunks: tuple[tuple[int, int], ...]
    ctas: int
    vecs: int


def sums_plan(batch: int, n: int, k_cols: int, max_cells: int, resident: int) -> SumsPlan:
    """K3's plan for (batch, n) labels with ``k_cols`` value lanes, given
    the card's ``resident`` CTAs (SMs x CTAs a SM): lanes in chunks of
    ``sums_width``, and about one wave of CTAs over the batch, each taking
    at least K3_MIN_VECS vectors. Raises ValueError for a table that no
    plan holds."""
    width = sums_width(k_cols, max_cells)
    if batch < 1 or batch > 65535 or n < 0:
        raise ValueError(f"K3 takes 1..65535 sites of n >= 0 pixels a launch (got {batch}, {n})")
    chunks = tuple((c, min(c + width, k_cols)) for c in range(0, k_cols, width))
    n_vec = n // 4  # no fewer than any site's aligned vectors
    ctas = max(1, min(-(-max(resident, 1) // batch), -(-n_vec // K3_MIN_VECS)))
    return SumsPlan(chunks, ctas, -(-n_vec // ctas))


@lru_cache(maxsize=None)
def sums_kernel_info(width: int, max_cells: int) -> dict[str, int]:
    """Resources of K3's ``width``-lane kernel with a (max_cells x width)
    table on the current card: registers and local (spilled) bytes a
    thread, dynamic shared bytes, resident CTAs a SM."""
    info = (ctypes.c_int * 4)()
    rc = _lib().sag_sums_info(width, max_cells, info)
    if rc != 0:
        raise RuntimeError(f"sag_sums_info failed: CUDA error {rc}")
    return dict(zip(("registers", "local_bytes", "smem", "ctas_per_sm"), info))


@lru_cache(maxsize=64)
def sums_card_plan(batch: int, n: int, k_cols: int, max_cells: int,
                   device: torch.device) -> SumsPlan:
    """``sums_plan`` for ``device``'s SMs and the kernel's residency."""
    per_sm = sums_kernel_info(sums_width(k_cols, max_cells), max_cells)["ctas_per_sm"]
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sums_plan(batch, n, k_cols, max_cells, sms * per_sm)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it whose data starts on a 16-byte boundary."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def sums_launches(labels: torch.Tensor, values: torch.Tensor, out: torch.Tensor,
                  plan: SumsPlan) -> list[tuple]:
    """The ``sag_sums`` argument lists of ``plan``'s launches (without the
    stream) and the tensors they point into, which must outlive them."""
    b, n = labels.shape
    k, mc = values.shape[2], out.shape[1]
    labels = _aligned(labels)
    launches = []
    for c0, c1 in plan.chunks:
        vals = values if (c0, c1) == (0, k) else values[..., c0:c1].contiguous()
        vals = _aligned(vals)
        launches.append(((labels.data_ptr(), vals.data_ptr(), out.data_ptr(), b, n, c1 - c0, k,
                          c0, mc, plan.ctas, plan.vecs), (labels, vals)))
    return launches


def seg_sums(labels: torch.Tensor, values: torch.Tensor, max_cells: int) -> torch.Tensor:
    """(B, N) int32 labels + (B, N, K) f32 values -> (B, max_cells, K) f32
    per-label sums (labels outside [0, max_cells) are dropped), one launch
    a lane chunk of ``sums_plan``."""
    _check(labels, "labels", torch.int32, 2)
    _check(values, "values", torch.float32, 3)
    b, n = labels.shape
    if values.shape[:2] != (b, n):
        raise ValueError(f"values {tuple(values.shape)} do not match labels {(b, n)}")
    k = values.shape[2]
    dev = labels.device
    plan = sums_card_plan(b, n, k, max_cells, dev)
    out = torch.zeros((b, max_cells, k), dtype=torch.float32, device=dev)
    for args, _ in sums_launches(labels, values, out, plan):
        _launch("sag_sums", "seg_sums", dev, *args)
    return out


def sums_plain(labels: torch.Tensor, values: torch.Tensor, max_cells: int,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch form of ``seg_sums`` (``index_add_`` into label rows),
    summed in ``dtype``."""
    b, n = labels.shape
    k = values.shape[2]
    lab = labels.long()
    ok = (lab >= 0) & (lab < max_cells)
    site = torch.arange(b, device=labels.device)[:, None] * max_cells
    idx = torch.where(ok, site + lab, b * max_cells).reshape(-1)
    out = torch.zeros((b * max_cells + 1, k), dtype=dtype, device=labels.device)
    out.index_add_(0, idx, values.reshape(b * n, k).to(dtype))
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


def lanes_kernel_info(pass_name: str, n_ch: int, flags: tuple[bool, bool, bool] = (False,) * 3):
    """Resources of the pass A (flags[2] = edge), pass C (flags = moments,
    zernike, edge) or pass E kernel at ``n_ch`` channels on the current
    card: registers and local (spilled) bytes a thread, dynamic shared
    bytes a block, and resident blocks a SM."""
    info = (ctypes.c_int * 4)()
    code = 4 * flags[0] + 2 * flags[1] + flags[2]
    rc = _lib().sag_lanes_info({"A": 0, "C": 1, "E": 2}[pass_name], code, n_ch, info)
    if rc != 0:
        raise RuntimeError(f"sag_lanes_info failed: CUDA error {rc}")
    return dict(zip(("registers", "local_bytes", "smem_bytes", "blocks_per_sm"), info))


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
    if max_cells < 1:
        raise ValueError(f"max_cells must be at least 1, got {max_cells}")
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
    Zernike radial coefficients, of which the kernel reads the 70 that are
    non-zero for R_n^m (powers m, m+2, ..., n) -> (B, max_cells,
    n_lanes_c) f32."""
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


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once, as one f32 fused multiply-add (fmaf; XLA's
    CPU backend contracts the reference's ``a * b + c`` into one): the
    product of two f32 values is exact in f64, and the f64 sum rounded to
    f32 differs from one fused rounding only where it lands on an f32
    rounding midpoint. f64 inputs are summed in f64."""
    if a.dtype == torch.float64:
        return a * b + c
    return (a.double() * b.double() + c.double()).float()


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root of f32 ``x`` (sqrtf; IEEE's and
    XLA's): torch's CPU kernel rounds about one value in 150 the other
    way. A square root taken in f64 and rounded to f32 is the correctly
    rounded f32 one."""
    return torch.sqrt(x.double()).to(x.dtype) if x.dtype == torch.float32 else torch.sqrt(x)


def rho_powers(rho: torch.Tensor) -> list:
    """rho**0 .. rho**9 as the reference's ``rho**k`` rounds them (JAX's
    integer_pow: square-and-multiply, x**7 = (x * x**2) * x**4)."""
    x2 = rho * rho
    x4 = x2 * x2
    x8 = x4 * x4
    return [torch.ones_like(rho), rho, x2, rho * x2, x4, rho * x4, x2 * x4, (rho * x2) * x4,
            x8, rho * x8]


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
        dist = sqrt32(fma32(dy, dy, dx * dx))
        inv_rmax = 1.0 / torch.clamp(g[:, o_rmax], min=1e-6)
        rho = torch.clamp(dist * inv_rmax, max=1.0)
        rp = rho_powers(rho)
        coef = zcoef.abs() if magnitude else zcoef
        # the reference's f32 dot: one fused multiply-add a power, ascending
        radials = torch.zeros((rho.shape[0], coef.shape[0]), dtype=rho.dtype, device=rho.device)
        for k in range(10):
            radials = fma32(rp[k][:, None], coef[:, k][None, :], radials)
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


# ---------------------------------------------------------------------------
# K4, pass E: the colocalization family's thresholded sums


def n_lanes_e(n_ch: int) -> int:
    return n_ch + 8 * len(_pairs(n_ch))


def seg_lane_sums_e(
    labels: torch.Tensor,
    image: torch.Tensor,
    ranks: torch.Tensor,
    tff: torch.Tensor,
    consts: torch.Tensor,
    max_cells: int,
) -> torch.Tensor:
    """Pass E sums. labels (B, N) int32 raw ids (ids >= max_cells fold into
    slot 0), image (B, N, C) f32, ranks (B, N, C) f32 dense ranks of the
    object set, tff (B, max_cells, C) f32 per-label Manders thresholds,
    consts (B, 3, P) f32 per-site Costes (thr_f, thr_s) and 1/R for the P
    channel pairs -> (B, max_cells, C + 8P) f32, ordered [tot_thr (C) |
    Manders a, b per pair | RWC a, b | Costes a, b, denom_a, denom_b]."""
    _check(labels, "labels", torch.int32, 2)
    _check(image, "image", torch.float32, 3)
    _check(ranks, "ranks", torch.float32, 3)
    _check(tff, "tff", torch.float32, 3)
    _check(consts, "consts", torch.float32, 3)
    b, n = labels.shape
    n_ch = image.shape[2]
    n_pairs = len(_pairs(n_ch))
    if image.shape != (b, n, n_ch) or ranks.shape != (b, n, n_ch):
        raise ValueError("labels, image and ranks must share (B, N) and image/ranks (B, N, C)")
    if tff.shape != (b, max_cells, n_ch) or consts.shape != (b, 3, n_pairs):
        raise ValueError(f"tff {tuple(tff.shape)} or consts {tuple(consts.shape)} do not match")
    if not 2 <= n_ch <= _MAX_CH:
        raise ValueError(f"pass E takes 2..{_MAX_CH} channels, got {n_ch}")
    if max_cells < 1:
        raise ValueError(f"max_cells must be at least 1, got {max_cells}")
    nl = n_lanes_e(n_ch)
    out = torch.zeros((b, max_cells, nl), dtype=torch.float32, device=labels.device)
    _launch(
        "sag_lanes_e", "seg_lane_sums_e", labels.device,
        labels.data_ptr(), image.data_ptr(), ranks.data_ptr(), tff.data_ptr(),
        consts.data_ptr(), out.data_ptr(), b, n, n_ch, max_cells, n_pairs,
    )
    return out


def _lanes_e(inside, vr, rk, g, thr_f, thr_s, inv_r):
    """Pass E lanes of P pixels: inside (P,), vr, rk, g (P, C) (g the
    gathered Manders thresholds), thr_f, thr_s, inv_r (P, pairs) ->
    (P, n_lanes_e), the column order of colocalization's lanes_e_fn."""
    above = (vr > g).to(vr.dtype) * inside[:, None]
    mand, rwcs, cots = [], [], []
    for i, (a, b) in enumerate(_pairs(vr.shape[1])):
        cmb = above[:, a] * above[:, b]
        mand += [vr[:, a] * cmb, vr[:, b] * cmb]
        w = 1.0 - (rk[:, a] - rk[:, b]).abs() * inv_r[:, i]
        rwcs += [vr[:, a] * w * cmb, vr[:, b] * w * cmb]
        ca = (vr[:, a] > thr_f[:, i]).to(vr.dtype) * inside
        cb = (vr[:, b] > thr_s[:, i]).to(vr.dtype) * inside
        cc = ca * cb
        cots += [vr[:, a] * cc, vr[:, b] * cc, vr[:, a] * ca, vr[:, b] * cb]
    return torch.cat([vr * above, torch.stack(mand + rwcs + cots, dim=1)], dim=1)


def lane_sums_e_plain(
    labels, image, ranks, tff, consts, max_cells, magnitude=False, dtype=torch.float32
):
    """Plain PyTorch form of ``seg_lane_sums_e``, summed in ``dtype``
    (``magnitude=True`` sums |lane|)."""
    b, n = labels.shape
    n_ch = image.shape[2]
    lab3 = labels.reshape(b, 1, n)
    img4 = image.reshape(b, 1, n, n_ch)
    rk_all = ranks.reshape(b * n, n_ch).to(dtype)
    tab = clean_table(tff).reshape(b * max_cells, n_ch).to(dtype)
    cst = consts.to(dtype)

    def build(sl, y, x, inside, bnd, vr, rows):
        site = torch.div(rows, max_cells, rounding_mode="floor")
        lanes = _lanes_e(inside, vr, rk_all[sl], tab[rows], cst[site, 0], cst[site, 1],
                         cst[site, 2])
        return lanes.abs() if magnitude else lanes

    border = torch.zeros_like(lab3, dtype=torch.uint8)
    return _lane_sums_plain(lab3, img4, border, max_cells, n_lanes_e(n_ch), build, dtype)


# ---------------------------------------------------------------------------
# K4, radial lanes: per-(label, ring/wedge bin) counts and channel sums

# K4 radial's launch plan (csrc/radial_sums.cu): like K3's, about one wave
# of CTAs, each over a contiguous range of a site's 16-byte vectors of 4
# pixels; a site's ragged head and tail go to its first CTA.
K4R_THREADS = 256               # K4R_THREADS in radial_sums.cu
K4R_UNROLL = 2                  # K4R_UNROLL in radial_sums.cu
K4R_MIN_VECS = K4R_THREADS * K4R_UNROLL  # vectors a CTA takes at least: one iteration


@dataclass(frozen=True)
class RadialPlan:
    """K4 radial's launch plan: ``ctas`` CTAs a site, each over ``vecs``
    16-byte vectors of the site's aligned pixels (the ragged head and tail
    of a site, at most 3 pixels each, go to its first CTA)."""

    ctas: int
    vecs: int


def radial_plan(batch: int, n: int, resident: int) -> RadialPlan:
    """K4 radial's plan for (batch, n) pixels, given the card's
    ``resident`` CTAs (SMs x CTAs a SM): about one wave of CTAs over the
    batch, each taking at least K4R_MIN_VECS vectors."""
    if batch < 1 or batch > 65535 or n < 0:
        raise ValueError(f"K4 radial takes 1..65535 sites of n >= 0 pixels (got {batch}, {n})")
    n_vec = n // 4  # no fewer than any site's aligned vectors
    ctas = max(1, min(-(-max(resident, 1) // batch), -(-n_vec // K4R_MIN_VECS)))
    return RadialPlan(ctas, -(-n_vec // ctas))


@lru_cache(maxsize=None)
def radial_kernel_info(n_ch: int) -> dict[str, int]:
    """Resources of K4 radial's ``n_ch``-channel kernel on the current card:
    registers and local (spilled) bytes a thread, resident CTAs a SM."""
    info = (ctypes.c_int * 3)()
    rc = _lib().sag_radial_info(n_ch, info)
    if rc != 0:
        raise RuntimeError(f"sag_radial_info failed: CUDA error {rc}")
    return dict(zip(("registers", "local_bytes", "ctas_per_sm"), info))


@lru_cache(maxsize=64)
def radial_card_plan(batch: int, n: int, n_ch: int, device: torch.device) -> RadialPlan:
    """``radial_plan`` for ``device``'s SMs and the kernel's residency."""
    per_sm = radial_kernel_info(n_ch)["ctas_per_sm"]
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return radial_plan(batch, n, sms * per_sm)


def radial_args(labels, codes, image, out, plan: RadialPlan) -> tuple[tuple, tuple]:
    """The ``sag_radial_sums`` arguments (without the stream) and the
    16-byte aligned tensors they point into, which must outlive them."""
    b, n = labels.shape
    labels, codes, image = _aligned(labels), _aligned(codes), _aligned(image)
    return ((labels.data_ptr(), codes.data_ptr(), image.data_ptr(), out.data_ptr(), b, n,
             image.shape[2], out.shape[1], out.shape[2], plan.ctas, plan.vecs),
            (labels, codes, image))


def seg_radial_sums(
    labels: torch.Tensor, codes: torch.Tensor, image: torch.Tensor, max_cells: int, n_codes: int
) -> torch.Tensor:
    """labels (B, N) int32 raw ids (ids >= max_cells fold into slot 0),
    codes (B, N) int32 packed bins ring*8 + wedge (a code outside
    [0, n_codes) is excluded), image (B, N, C) f32 -> (B, max_cells,
    n_codes, 1 + C) f32: per (label, bin) the pixel count and the channel
    sums of the labelled pixels, one launch of ``radial_plan``."""
    _check(labels, "labels", torch.int32, 2)
    _check(codes, "codes", torch.int32, 2)
    _check(image, "image", torch.float32, 3)
    b, n = labels.shape
    n_ch = image.shape[2]
    if codes.shape != (b, n) or image.shape[:2] != (b, n):
        raise ValueError("labels, codes and image must share (B, N)")
    if not 1 <= n_ch <= _MAX_CH:
        raise ValueError(f"the radial kernel takes 1..{_MAX_CH} channels, got {n_ch}")
    if max_cells < 1 or n_codes < 1:
        raise ValueError(f"K4 radial needs max_cells and n_codes >= 1: {max_cells}, {n_codes}")
    dev = labels.device
    plan = radial_card_plan(b, n, n_ch, dev)
    out = torch.zeros((b, max_cells, n_codes, 1 + n_ch), dtype=torch.float32, device=dev)
    args, _keep = radial_args(labels, codes, image, out, plan)
    _launch("sag_radial_sums", "seg_radial_sums", dev, *args)
    return out


def radial_sums_plain(labels, codes, image, max_cells, n_codes, dtype=torch.float32):
    """Plain PyTorch form of ``seg_radial_sums`` (``index_add_`` into
    (label, bin) rows), summed in ``dtype``."""
    b, n = labels.shape
    n_ch = image.shape[2]
    raw = labels.long()
    code = codes.long()
    act = (raw > 0) & (code >= 0) & (code < n_codes)
    slot = torch.where(raw < max_cells, raw, torch.zeros_like(raw))
    site = torch.arange(b, device=labels.device)[:, None] * (max_cells * n_codes)
    size = b * max_cells * n_codes
    key = torch.where(act, site + slot * n_codes + code, size).reshape(-1)
    vals = torch.cat([torch.ones((b, n, 1), dtype=dtype, device=labels.device),
                      image.to(dtype)], dim=2).reshape(b * n, 1 + n_ch)
    out = torch.zeros((size + 1, 1 + n_ch), dtype=dtype, device=labels.device)
    out.index_add_(0, key, vals)
    return out[:size].view(b, max_cells, n_codes, 1 + n_ch)


# ---------------------------------------------------------------------------
# K5: bounded horizontal EDT sweep

# K5's row geometry (csrc/edt_sweep.cu): one warp a row, its groups of
# K5_P consecutive outputs handed to the lanes as a queue, K5_S steps of dx
# a block; the row of v2 staged in shared memory with a halo of the radius
# rounded up to K5_S and one minimum a K5_BLOCK values, the row of d2, and
# each group's bound.
K5_P = 8                        # K5_P in edt_sweep.cu
K5_S = 8                        # K5_S
K5_BLOCK = 32                   # K5_BLOCK
K5_WARPS = 4                    # K5_WARPS: rows a CTA at most
K5_SMEM_MAX = 232448            # K5_SMEM_MAX: dynamic shared bytes a CTA


@dataclass(frozen=True)
class EdtGeometry:
    """K5's geometry for rows of ``w`` pixels: ``reff`` steps of dx (the
    radius, at most w - 1: steps past the row only meet +inf), a halo of
    ``kp`` (reff rounded up to K5_S), ``wp`` staged floats of d2 a row (w
    rounded up to K5_P), ``span`` staged floats of v2 a row (wp and both
    halos, rounded up to 32), ``warps`` rows a CTA and ``smem`` dynamic
    shared bytes a CTA."""

    reff: int
    kp: int
    wp: int
    span: int
    warps: int
    smem: int


def edt_geometry(w: int, radius: int) -> EdtGeometry:
    """K5's geometry for rows of ``w`` pixels; raises ValueError where one
    staged row exceeds a CTA's shared memory."""
    if radius < 0 or w < 1:
        raise ValueError(f"K5 needs radius >= 0 and w >= 1 (got {radius}, {w})")
    reff = min(radius, w - 1)
    kp = -(-reff // K5_S) * K5_S
    wp = -(-w // K5_P) * K5_P
    span = -(-(wp + 2 * kp) // 32) * 32
    per_warp = 4 * (span + wp + span // K5_BLOCK + wp // K5_P)
    if per_warp > K5_SMEM_MAX:
        raise ValueError(f"a row of {w} pixels with radius {radius} exceeds shared memory")
    warps = min(K5_WARPS, K5_SMEM_MAX // per_warp)
    return EdtGeometry(reff, kp, wp, span, warps, warps * per_warp)


@lru_cache(maxsize=None)
def edt_kernel_info(w: int, radius: int, vec: bool = True) -> dict[str, int]:
    """Resources of K5's kernel (``vec``: its 16-byte form) for rows of
    ``w`` pixels at ``radius`` on the current card: registers and local
    (spilled) bytes a thread, dynamic shared bytes and resident CTAs a SM,
    warps (rows) a CTA."""
    info = (ctypes.c_int * 5)()
    rc = _lib().sag_edt_sweep_info(int(vec), w, radius, info)
    if rc != 0:
        raise RuntimeError(f"sag_edt_sweep_info failed: CUDA error {rc}")
    return dict(zip(("registers", "local_bytes", "smem", "ctas_per_sm", "warps"), info))


def seg_edt_sweep(v2: torch.Tensor, d2_init: torch.Tensor, max_radius: int) -> torch.Tensor:
    """v2, d2_init (B, H, W) f32 -> (B, H, W) f32: ``min(d2_init,
    min_{1 <= |dx| <= R} v2[row, col + dx] + dx**2)``, candidates outside
    the row read as +inf, NaN kept. Exact."""
    _check(v2, "v2", torch.float32, 3)
    _check(d2_init, "d2_init", torch.float32, 3)
    if v2.shape != d2_init.shape:
        raise ValueError(f"v2 {tuple(v2.shape)} and d2_init {tuple(d2_init.shape)} differ")
    b, h, w = v2.shape
    edt_geometry(w, max_radius)  # raises where a row does not fit
    out = torch.empty_like(v2)
    _launch(
        "sag_edt_sweep", "seg_edt_sweep", v2.device,
        v2.data_ptr(), d2_init.data_ptr(), out.data_ptr(), b, h, w, max_radius,
    )
    return out


def edt_sweep_plain(v2: torch.Tensor, d2_init: torch.Tensor, max_radius: int) -> torch.Tensor:
    """Plain PyTorch form of ``seg_edt_sweep``: 2R shifted min-adds."""
    w = v2.shape[-1]
    v2p = torch.nn.functional.pad(v2, (max_radius, max_radius), value=float("inf"))
    d2 = d2_init
    for dx in range(1, max_radius + 1):
        left = v2p[..., max_radius - dx : max_radius - dx + w]
        right = v2p[..., max_radius + dx : max_radius + dx + w]
        d2 = torch.minimum(d2, torch.minimum(left, right) + float(dx * dx))
    return d2


# ---------------------------------------------------------------------------
# K6: per-pixel two-level table pick


# K6's launch plan (csrc/pick2.cu): each site cut into ranges of
# K6_CTA_VECS 16-byte vectors of 4 items (a pixel's channels), one a CTA,
# as many CTAs as that takes; a site's ragged head and tail go to its
# first CTA.
K6_THREADS = 256                # K6_THREADS in pick2.cu
K6_CTA_VECS = 2 * K6_THREADS    # vectors a CTA: two a thread
K6_MAX_KC = 4                   # K6_MAX_KC: object sets a launch (more go in chunks)
K6_MAX_INDEX = 2**31            # the kernel's 32-bit item and table-row indices stay below


@dataclass(frozen=True)
class Pick2Plan:
    """K6's launch plan: ``ctas`` CTAs a site, each over ``vecs`` 16-byte
    vectors of the site's aligned items (the ragged head and tail of a site,
    at most 3 items each, go to its first CTA)."""

    ctas: int
    vecs: int


def pick2_plan(batch: int, n: int, n_ch: int) -> Pick2Plan:
    """K6's plan for (batch, n, n_ch) codes: K6_CTA_VECS vectors a CTA.
    Raises ValueError where a site's n * n_ch items do not fit the
    kernel's 32-bit index."""
    if batch < 1 or batch > 65535 or n < 0 or n_ch < 1:
        raise ValueError(f"K6 takes 1..65535 sites of n >= 0 pixels and >= 1 channels "
                         f"(got {batch}, {n}, {n_ch})")
    if n * n_ch >= K6_MAX_INDEX:
        raise ValueError(f"K6 indexes a site's items in 32 bits: {n} x {n_ch} items exceed it")
    n_vec = n * n_ch // 4  # no fewer than any site's aligned vectors
    return Pick2Plan(max(1, -(-n_vec // K6_CTA_VECS)), K6_CTA_VECS)


@lru_cache(maxsize=None)
def pick2_kernel_info(kc: int) -> dict[str, int]:
    """Resources of K6's ``kc``-set kernel on the current card: registers
    and local (spilled) bytes a thread, resident CTAs a SM."""
    info = (ctypes.c_int * 3)()
    rc = _lib().sag_pick2_info(kc, info)
    if rc != 0:
        raise RuntimeError(f"sag_pick2_info failed: CUDA error {rc}")
    return dict(zip(("registers", "local_bytes", "ctas_per_sm"), info))


def pick2_out(b: int, n: int, n_ch: int, k: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """K6's output, set-major: a (K, plane) f32 buffer whose row k holds set
    k's (B, N, C) ranks from its start (plane: B * N * C rounded up to 4, so
    that every row starts 16-byte aligned), and the (B, N, C, K) view of it
    that ``seg_pick2`` and ``pick2_plain`` return, whose ``[..., k]`` is
    contiguous."""
    m = b * n * n_ch
    buf = torch.empty((k, -(-m // 4) * 4), dtype=torch.float32, device=device)
    return buf, buf[:, :m].view(k, b, n, n_ch).permute(1, 2, 3, 0)


def pick2_args(hi, lo, tables, buf, plan: Pick2Plan) -> tuple[tuple, tuple]:
    """The ``sag_pick2`` arguments (without the stream) and the 16-byte
    aligned tensors they point into, which must outlive them."""
    b, n, n_ch = hi.shape
    hi, lo, tables = _aligned(hi), _aligned(lo), _aligned(tables)
    return ((hi.data_ptr(), lo.data_ptr(), tables.data_ptr(), buf.data_ptr(), b, n, n_ch,
             tables.shape[4], buf.shape[1], plan.ctas, plan.vecs), (hi, lo, tables))


def seg_pick2(hi: torch.Tensor, lo: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """hi, lo (B, N, C) int32 byte codes + tables (B, C, 256, 256, K) f32 ->
    (B, N, C, K) f32: ``tables[b, c, hi[b, i, c], lo[b, i, c], k]``, exact
    (codes outside [0, 256) give 0), laid out set-major (``pick2_out``:
    each ``[..., k]`` is contiguous). One call of ``pick2_plan``'s launch,
    a kernel a chunk of at most K6_MAX_KC sets. Raises ValueError where an
    index would overflow 32 bits: a site of n * C >= 2^31 items, or
    tables of C * 65536 * K >= 2^31 floats a site."""
    if hi.dim() != 3 or lo.shape != hi.shape or tables.dim() != 5 \
            or tables.shape[:4] != (hi.shape[0], hi.shape[2], 256, 256) or tables.shape[4] < 1:
        raise ValueError(f"hi {tuple(hi.shape)}, lo {tuple(lo.shape)} and tables "
                         f"{tuple(tables.shape)} do not match")
    b, n, n_ch = hi.shape
    k = tables.shape[4]
    plan = pick2_plan(b, n, n_ch)  # raises where the items overflow the 32-bit index
    if n_ch * 65536 * k >= K6_MAX_INDEX:
        raise ValueError(f"K6 indexes a site's table rows in 32 bits: {n_ch} x 65536 x {k} "
                         "floats exceed it")
    _check(hi, "hi", torch.int32, 3)
    _check(lo, "lo", torch.int32, 3)
    _check(tables, "tables", torch.float32, 5)
    dev = hi.device
    buf, out = pick2_out(b, n, n_ch, k, dev)
    args, _keep = pick2_args(hi, lo, tables, buf, plan)
    _launch("sag_pick2", "seg_pick2", dev, *args)
    return out


def pick2_plain(hi: torch.Tensor, lo: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch form of ``seg_pick2`` (an indexed gather), in the same
    set-major layout."""
    b, n, n_ch = hi.shape
    k = tables.shape[4]
    h, l = hi.long(), lo.long()
    ok = (h >= 0) & (h < 256) & (l >= 0) & (l < 256)
    idx = torch.where(ok, h * 256 + l, torch.zeros_like(h))
    flat = tables.reshape(b, n_ch, 65536, k).permute(3, 0, 1, 2)  # (K, B, C, 65536)
    site = torch.arange(b, device=hi.device)[:, None, None]
    chan = torch.arange(n_ch, device=hi.device)[None, None, :]
    sets = flat[:, site, chan, idx]  # (K, B, N, C)
    buf, out = pick2_out(b, n, n_ch, k, hi.device)
    out.permute(3, 0, 1, 2).copy_(torch.where(ok, sets, torch.zeros_like(sets)))
    return out


# ---------------------------------------------------------------------------
# K8: the granularity spectrum's reconstructions, every scale in one launch

K8_TILE = 32  # K8_T in granularity.cu: a warp's tile is K8_TILE x K8_TILE pixels


@lru_cache(maxsize=None)
def granularity_kernel_info(b: int, h: int, w: int) -> dict[str, int]:
    """Resources of K8's kernel on the current card and its grid for (b, h,
    w) planes: registers and local (spilled) bytes a thread, shared bytes
    and resident CTAs a SM, SMs, the grid's CTAs and the tiles."""
    info = (ctypes.c_int * 7)()
    rc = _lib().sag_granularity_info(b, h, w, info)
    if rc != 0:
        raise RuntimeError(f"sag_granularity_info failed: CUDA error {rc}")
    return dict(zip(("registers", "local_bytes", "smem", "ctas_per_sm", "sms", "ctas", "tiles"),
                    info))


def sag_granularity(pixels: torch.Tensor, spectrum_length: int) -> torch.Tensor:
    """pixels (B, H, W) f32, background removed -> (B, spectrum_length) f32:
    step 3 of ``morphology.granularity_spectrum_cp`` (cross erosions,
    reconstructions by dilation under ``pixels``, the mean of each scale's
    removed volume x 100 over the mean pixel) in one launch and no host
    read. Each reconstruction equals the plain form's bit for bit; only
    the order of the per-plane sums differs, and a call is deterministic.
    With a recorder active (``utils.timing``) its grid rounds and in-tile
    scans, summed over the scales, are fetched and counted as
    ``rounds/granularity.grid`` and ``rounds/granularity.tile``."""
    _check(pixels, "pixels", torch.float32, 3)
    b, h, w = pixels.shape
    if min(b, h, w) < 1 or spectrum_length < 1:
        raise ValueError(f"K8 needs planes of at least 1 pixel and a spectrum length of at "
                         f"least 1 (got {tuple(pixels.shape)}, {spectrum_length})")
    n_tiles = b * -(-h // K8_TILE) * -(-w // K8_TILE)  # the last row and column ragged
    dev = pixels.device
    scratch = torch.empty((3, b, h, w), dtype=torch.float32, device=dev)
    part = torch.empty((n_tiles, spectrum_length + 1), dtype=torch.float64, device=dev)
    flags = torch.empty(2 * n_tiles + 3, dtype=torch.int32, device=dev)
    counters = torch.empty(2, dtype=torch.int32, device=dev)
    out = torch.empty((b, spectrum_length), dtype=torch.float32, device=dev)
    _launch(
        "sag_granularity", "sag_granularity", dev,
        pixels.data_ptr(), scratch.data_ptr(), part.data_ptr(), flags.data_ptr(),
        counters.data_ptr(), out.data_ptr(), b, h, w, spectrum_length,
    )
    if timing.is_recording():
        grid_rounds, tile_scans = timing.fetch(counters, "granularity")
        timing.count("rounds/granularity.grid", int(grid_rounds))
        timing.count("rounds/granularity.tile", int(tile_scans))
    return out
