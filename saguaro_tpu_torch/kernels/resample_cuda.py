"""Hopper kernel K7: the banded Lanczos re-binner, and its binding.

``csrc/lanczos.cu`` replaces ``saguaro_tpu/kernels/resample_pallas.py``
(``lanczos_resize_pallas`` / ``lanczos_resize_batch_pallas``). It is built
into the same shared library as K1-K6 (``segment_cuda.build_kernels``) and
goes through the same checks and launch helper, so its launches count in
``segment_cuda.LAUNCHES["lanczos_resize"]``. One launch covers a batch.
The plain form is ``kernels.resample.resize_plain``; ``kernels.resample``
dispatches by the tensor's device and builds the coefficient tables.
"""

from __future__ import annotations

import torch

from saguaro_tpu_torch.kernels.segment_cuda import _check, _launch

__all__ = ["lanczos_resize_cuda"]

_DTYPE_CODES = {torch.uint8: 0, torch.uint16: 1, torch.float32: 2}


def lanczos_resize_cuda(imgs: torch.Tensor, y_tab, x_tab) -> torch.Tensor:
    """imgs (B, H, W) uint8, uint16 or f32, read in place -> (B, h, w) f32
    before rounding. ``y_tab`` = (start (h,) int32, n (h,) int32, weights
    (h, taps) f32) and ``x_tab`` = (start (w,), n (w,), weights (taps, w))
    are ``resample.axis_windows`` tables on the same device, the x weights
    transposed."""
    if imgs.dtype not in _DTYPE_CODES:
        raise ValueError(f"imgs must be one of {list(_DTYPE_CODES)} (got {imgs.dtype})")
    _check(imgs, "imgs", imgs.dtype, 3)
    b, in_h, in_w = imgs.shape
    y0, ny, wy = y_tab
    x0, nx, wxt = x_tab
    for name, t, dt, nd in (("y0", y0, torch.int32, 1), ("ny", ny, torch.int32, 1),
                            ("wy", wy, torch.float32, 2), ("x0", x0, torch.int32, 1),
                            ("nx", nx, torch.int32, 1), ("wxt", wxt, torch.float32, 2)):
        _check(t, name, dt, nd)
        if t.device != imgs.device:
            raise ValueError(f"{name} is on {t.device}, imgs on {imgs.device}")
    out_h, out_w = y0.shape[0], x0.shape[0]
    if ny.shape != (out_h,) or wy.shape[0] != out_h or nx.shape != (out_w,) or wxt.shape[1] != out_w:
        raise ValueError("the y and x coefficient tables do not match their output sizes")
    if not 1 <= b <= 65535:
        raise ValueError(f"batch of {b} images; K7 takes 1..65535 per launch")
    out = torch.empty((b, out_h, out_w), dtype=torch.float32, device=imgs.device)
    _launch(
        "sag_lanczos", "lanczos_resize", imgs.device,
        imgs.data_ptr(), _DTYPE_CODES[imgs.dtype], out.data_ptr(), y0.data_ptr(), ny.data_ptr(),
        wy.data_ptr(), wy.shape[1], x0.data_ptr(), nx.data_ptr(), wxt.data_ptr(),
        b, in_h, in_w, out_h, out_w,
    )
    return out
