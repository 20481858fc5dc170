"""Hopper kernel K7: the banded Lanczos re-binner, its launch plan and its
binding.

``csrc/lanczos.cu`` replaces ``saguaro_tpu/kernels/resample_pallas.py``
(``lanczos_resize_pallas`` / ``lanczos_resize_batch_pallas``). It is built
into the same shared library as K1-K6 (``segment_cuda.build_kernels``) and
goes through the same checks and launch helper, so its launches count in
``segment_cuda.LAUNCHES["lanczos_resize"]``. One launch covers a batch.
The plain form is ``kernels.resample.resize_plain``; ``kernels.resample``
dispatches by the tensor's device and builds the band tables
(``resample.axis_bands``).
"""

from __future__ import annotations

import ctypes
from collections.abc import Callable
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from saguaro_tpu_torch.kernels.segment_cuda import _check, _launch, _lib

__all__ = ["LanczosPlan", "lanczos_plan", "lanczos_smem", "lanczos_card_plan",
           "lanczos_kernel_info", "plan_windows", "lanczos_args", "staged_cols",
           "lanczos_resize_cuda"]

_DTYPE_CODES = {torch.uint8: 0, torch.uint16: 1, torch.float32: 2}

LZ_ROWS = 64               # LZ_ROWS in lanczos.cu: output rows a tile, 16 bands of 4
LZ_BANDS = LZ_ROWS // 4
LZ_COLS = 128              # staged columns a ring buffer at most (16 groups of 8)
LZ_SMEM = 200 * 1024       # shared bytes a CTA at most: two ring buffers and the intermediate
LZ_BOX_ROWS = 256          # rows of one TMA box, and so of a ring buffer


@dataclass(frozen=True)
class LanczosPlan:
    """K7's launch plan: output tiles of LZ_ROWS rows x 4 * ``ngx`` columns;
    two ring buffers of ``rows`` (at most LZ_BOX_ROWS) x ``cols`` input
    elements (``cols`` a multiple of 16, the row pitch: one TMA box), chunks
    of a window that exceeds them
    staged in turn; ``smem`` dynamic shared bytes a CTA; ``tiles`` of the
    whole batch; ``ctas`` persistent CTAs walking them; ``ywin`` and
    ``xwin`` the input rows and columns [lo, hi) each tile row and tile
    column needs (the union of its bands' windows)."""

    ngx: int
    rows: int
    cols: int
    smem: int
    tiles: int
    ctas: int
    ywin: tuple[tuple[int, int], ...]
    xwin: tuple[tuple[int, int], ...]


def _windows(meta: np.ndarray, per: int) -> list[tuple[int, int]]:
    """The input range [lo, hi) each tile of ``per`` bands needs: the union
    of its bands' windows ((0, 0) for a tile with no taps)."""
    out = []
    for g0 in range(0, len(meta), per):
        m = meta[g0 : g0 + per]
        m = m[m[:, 1] > 0]
        out.append((int(m[:, 0].min()), int((m[:, 0] + m[:, 1]).max())) if len(m) else (0, 0))
    return out


def staged_cols(lo: int, hi: int, itemsize: int) -> int:
    """Elements a ring buffer's row must hold to stage input columns [lo,
    hi) from the 16-byte boundary at or below lo, rounded up to 16."""
    e = 16 // itemsize
    return -(-(hi - (lo & ~(e - 1))) // 16) * 16 if hi > lo else 0


def lanczos_plan(y_meta: np.ndarray, x_meta: np.ndarray, batch: int, itemsize: int,
                 n_sms: int, ctas_per_sm: Callable[[int, int], int]) -> LanczosPlan:
    """K7's plan for a batch of ``batch`` images with each axis' band
    ``meta`` (``resample.axis_bands``) and ``itemsize`` bytes an input
    element: the most column bands a tile (at most 16) whose staged window
    fits LZ_COLS columns, ring buffers of the tallest tile window's rows as
    far as LZ_BOX_ROWS and LZ_SMEM allow (a taller or wider window is staged
    in chunks),
    and one persistent CTA a resident slot: ``n_sms`` SMs times
    ``ctas_per_sm(rows, cols)``, the card's count for those buffers. A pure
    function of its arguments."""
    if itemsize not in (1, 2, 4) or batch < 1 or len(y_meta) < 1 or len(x_meta) < 1:
        raise ValueError(f"K7 needs 1, 2 or 4-byte inputs and non-empty tables (got {itemsize})")
    for ngx in range(LZ_BANDS, 0, -1):
        xwin = _windows(x_meta, ngx)
        cols = max(staged_cols(lo, hi, itemsize) for lo, hi in xwin)
        if cols <= LZ_COLS:
            break
    cols = max(16, min(cols, LZ_COLS))
    rest = cols * LZ_ROWS * 4 + 16 + 2 * 127  # the intermediate, two barriers, alignment
    ywin = _windows(y_meta, LZ_BANDS)
    rows = max(1, min(max(hi - lo for lo, hi in ywin), LZ_BOX_ROWS,
                      (LZ_SMEM - rest) // (2 * cols * itemsize)))
    tiles = batch * len(ywin) * len(xwin)
    resident = n_sms * max(1, ctas_per_sm(rows, cols))
    return LanczosPlan(ngx, rows, cols, lanczos_smem(rows, cols, itemsize), tiles,
                       min(resident, tiles), tuple(ywin), tuple(xwin))


def lanczos_smem(rows: int, cols: int, itemsize: int) -> int:
    """K7's dynamic shared bytes (lz_smem_bytes in lanczos.cu): two ring
    buffers of rows x cols elements, each rounded up to 128 bytes, the
    (cols x 64) f32 intermediate and two 8-byte barriers."""
    buf = -(-rows * cols * itemsize // 128) * 128
    return 2 * buf + cols * LZ_ROWS * 4 + 16


@lru_cache(maxsize=None)
def lanczos_kernel_info(dtype_code: int, rows: int, cols: int) -> dict[str, int]:
    """Resources of K7's kernel for an input dtype code (0 uint8, 1 uint16,
    2 f32) with ring buffers of ``rows`` x ``cols`` on the current card:
    registers and local (spilled) bytes a thread, dynamic shared bytes,
    resident CTAs a SM."""
    info = (ctypes.c_int * 4)()
    rc = _lib().sag_lanczos_info(dtype_code, rows, cols, info)
    if rc != 0:
        raise RuntimeError(f"sag_lanczos_info failed: CUDA error {rc}")
    return dict(zip(("registers", "local_bytes", "smem", "ctas_per_sm"), info))


def lanczos_card_plan(y_meta: np.ndarray, x_meta: np.ndarray, batch: int,
                      dtype: torch.dtype, device: torch.device) -> LanczosPlan:
    """``lanczos_plan`` for ``device``'s SMs and the kernel's residency."""
    code = _DTYPE_CODES[dtype]
    return lanczos_plan(
        y_meta, x_meta, batch, torch.empty((), dtype=dtype).element_size(),
        torch.cuda.get_device_properties(device).multi_processor_count,
        lambda rows, cols: lanczos_kernel_info(code, rows, cols)["ctas_per_sm"],
    )


@lru_cache(maxsize=32)
def plan_windows(plan: LanczosPlan, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """``plan``'s tile windows (ywin, xwin) as int32 tensors on ``device``."""
    return tuple(torch.tensor(w, dtype=torch.int32, device=device) for w in (plan.ywin, plan.xwin))


def lanczos_args(imgs: torch.Tensor, y_bands, x_bands, plan: LanczosPlan,
                 out: torch.Tensor) -> tuple:
    """The ``sag_lanczos`` argument list (without the stream) for ``imgs``
    into ``out`` under ``plan``, each axis' band tables ``(meta, weights)``
    on the device."""
    b, in_h, in_w = imgs.shape
    (ym, yw), (xm, xw) = y_bands, x_bands
    ywin, xwin = plan_windows(plan, imgs.device)
    return (imgs.data_ptr(), _DTYPE_CODES[imgs.dtype], out.data_ptr(), ym.data_ptr(),
            yw.data_ptr(), ym.shape[0], yw.shape[1], xm.data_ptr(), xw.data_ptr(), xm.shape[0],
            xw.shape[1], ywin.data_ptr(), xwin.data_ptr(), b, in_h, in_w, out.shape[1],
            out.shape[2], plan.ngx, plan.rows, plan.cols, plan.ctas)


def lanczos_resize_cuda(imgs: torch.Tensor, y_bands, x_bands, plan: LanczosPlan,
                        out_shape: tuple[int, int]) -> torch.Tensor:
    """imgs (B, H, W) uint8, uint16 or f32, read in place -> (B, h, w) f32
    before rounding. ``y_bands`` and ``x_bands`` are each axis'
    ``resample.axis_bands`` tables (meta (G, 2) int32, weights (G, span, 4)
    f32) on the same device; ``plan`` is ``lanczos_card_plan``'s for them."""
    if imgs.dtype not in _DTYPE_CODES:
        raise ValueError(f"imgs must be one of {list(_DTYPE_CODES)} (got {imgs.dtype})")
    _check(imgs, "imgs", imgs.dtype, 3)
    b = imgs.shape[0]
    out_h, out_w = out_shape
    for name, (meta, w), size in (("y", y_bands, out_h), ("x", x_bands, out_w)):
        _check(meta, f"{name} meta", torch.int32, 2)
        _check(w, f"{name} weights", torch.float32, 3)
        if meta.device != imgs.device or w.device != imgs.device:
            raise ValueError(f"the {name} band tables are not on {imgs.device}")
        if meta.shape != (-(-size // 4), 2) or w.shape[0] != meta.shape[0] or w.shape[2] != 4:
            raise ValueError(f"the {name} band tables do not match an output size of {size}")
    if not 1 <= b <= 65535:
        raise ValueError(f"batch of {b} images; K7 takes 1..65535 per launch")
    out = torch.empty((b, out_h, out_w), dtype=torch.float32, device=imgs.device)
    _launch("sag_lanczos", "lanczos_resize", imgs.device,
            *lanczos_args(imgs, y_bands, x_bands, plan, out))
    return out
