"""Flow-following mask recovery — the Cellpose dynamics
(port of ``saguaro_tpu/kernels/flow_ode.py``).

Pixels above the cell-probability threshold are advected along the flow
field, by one of two integrators: stepwise Euler with bilinear flow
interpolation (``follow_flows``, the single-site path), or pointer
jumping (``follow_flows_pointer``, the batched path: each pixel follows
the integer-rounded flow step, and composing the successor map with
itself k times integrates 2^k steps). Converged positions are
histogrammed, local maxima become seeds, seed labels spread over the
dense region by 3x3 max sweeps, and every active pixel takes the label
of its converged position. Relabeling and hole filling are host-side
numpy/scipy post-passes.

Batched: flows (B, 2, H, W), cellprob and labels (B, H, W).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from saguaro_tpu_torch.device import resolve_device
from saguaro_tpu_torch.utils import timing

__all__ = [
    "follow_flows",
    "follow_flows_pointer",
    "masks_from_flows",
    "compute_masks",
    "compute_masks_batch",
    "centroid_flows",
    "flow_qc_error",
    "flow_qc_error_batch",
    "relabel_consecutive",
    "fill_label_holes",
]


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c in f32 with one rounding: the f64 product of two f32
    values is exact, so the f64 sum rounded to f32 is the fused result
    (barring a double rounding, about once in 2^29 operations)."""
    return (a.double() * b.double() + c.double()).float()


def _bilinear(field: torch.Tensor, py: torch.Tensor, px: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of (B, H, W) ``field`` at float positions (B, N),
    corners clipped to the image. The four corner terms are summed as the
    reference's compiled expression sums them: the first two as one fused
    multiply-add, then one more for each further term. A step's flow
    agrees to the bit, and the bits matter: over 200 steps of a
    diverging field a last-bit difference grows to pixels."""
    b, h, w = field.shape
    y0 = torch.clamp(torch.floor(py), 0, h - 1)
    x0 = torch.clamp(torch.floor(px), 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    wy = py - y0
    wx = px - x0
    flat = field.reshape(b, h * w)

    def take(yy, xx):
        return torch.gather(flat, 1, (yy * w + xx).to(torch.int64))

    s = _fma(take(y0, x0) * (1 - wy), 1 - wx, take(y0, x1) * (1 - wy) * wx)
    s = _fma(take(y1, x0) * wy, 1 - wx, s)
    return _fma(take(y1, x1) * wy, wx, s)


def follow_flows(flows: torch.Tensor, active: torch.Tensor, n_iters: int = 200) -> torch.Tensor:
    """Stepwise Euler flow following: (B, 2, H, W) [dy, dx] flows toward
    the cell centres + (B, H, W) active -> (B, 2, H, W) final positions
    (f32). Each of the ``n_iters`` steps samples the flow bilinearly at
    every pixel's position; inactive pixels carry zero flow and do not
    move, and positions are clipped to the image."""
    b, _, h, w = flows.shape
    dev = flows.device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    fy = torch.where(active, flows[:, 0].float(), zero)
    fx = torch.where(active, flows[:, 1].float(), zero)
    py = torch.arange(h, dtype=torch.float32, device=dev).repeat_interleave(w).expand(b, -1)
    px = torch.arange(w, dtype=torch.float32, device=dev).repeat(h).expand(b, -1)
    for _ in range(n_iters):
        dy = _bilinear(fy, py, px)
        dx = _bilinear(fx, py, px)
        py = torch.clamp(py + dy, 0.0, h - 1.0)
        px = torch.clamp(px + dx, 0.0, w - 1.0)
    return torch.stack([py, px], dim=1).reshape(b, 2, h, w)


def follow_flows_pointer(
    flows: torch.Tensor, active: torch.Tensor, n_doublings: int = 8
) -> torch.Tensor:
    """Pointer-jumping flow following: (B, 2, H, W) flows + (B, H, W)
    active -> (B, 2, H, W) final positions (integer-valued f32). Each
    pixel's successor is its rounded (half to even) single step, clipped
    to the image; ``n_doublings`` compositions integrate 2^n steps."""
    b, _, h, w = flows.shape
    dev = flows.device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    fy = torch.where(active, flows[:, 0].float(), zero)
    fx = torch.where(active, flows[:, 1].float(), zero)
    yy = torch.arange(h, device=dev, dtype=torch.int32)[:, None].expand(h, w)
    xx = torch.arange(w, device=dev, dtype=torch.int32)[None, :].expand(h, w)
    ny = torch.clamp(torch.round(yy + fy), 0, h - 1).to(torch.int64)
    nx = torch.clamp(torch.round(xx + fx), 0, w - 1).to(torch.int64)
    p = (ny * w + nx).reshape(b, -1)
    for _ in range(n_doublings):
        p = torch.gather(p, 1, p)
    py = torch.div(p, w, rounding_mode="floor").float().reshape(b, h, w)
    px = (p % w).float().reshape(b, h, w)
    return torch.stack([py, px], dim=1)


def _maxpool(x: torch.Tensor, k: int) -> torch.Tensor:
    """(B, H, W) k x k max window, SAME, outside ignored."""
    return F.max_pool2d(x[:, None], k, stride=1, padding=k // 2)[:, 0]


def masks_from_flows(
    positions: torch.Tensor,
    active: torch.Tensor,
    seed_threshold: float = 10.0,
    expand_iters: int = 5,
) -> torch.Tensor:
    """Cluster converged (B, 2, H, W) positions into (B, H, W) int32 labels
    (linear index + 1 of the seed histogram cell; relabel on the host)."""
    b, h, w = active.shape
    dev = active.device
    py = torch.clamp(torch.round(positions[:, 0]), 0, h - 1).to(torch.int64)
    px = torch.clamp(torch.round(positions[:, 1]), 0, w - 1).to(torch.int64)
    flat = (py * w + px).reshape(b, -1)
    ones = active.reshape(b, -1).float()
    hist = torch.zeros((b, h * w), dtype=torch.float32, device=dev)
    hist.scatter_add_(1, flat, ones)
    hist = hist.reshape(b, h, w)
    hmax = _maxpool(hist, 5)
    seeds = (hist >= hmax) & (hist > seed_threshold)
    lin = (torch.arange(h * w, dtype=torch.int32, device=dev) + 1).reshape(h, w)
    labels = torch.where(seeds, lin, torch.zeros_like(lin))
    grow = hist > 2.0
    for _ in range(expand_iters):
        neigh = _maxpool(labels.float(), 3).to(torch.int32)
        labels = torch.where(grow & (labels == 0), neigh, labels)
    pixel_labels = torch.gather(labels.reshape(b, -1), 1, flat).reshape(b, h, w)
    return torch.where(active, pixel_labels, torch.zeros_like(pixel_labels))


def flow_qc_error_batch(
    labels: torch.Tensor, flows: torch.Tensor, max_cells: int = 4096
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-label mean squared deviation between predicted (B, 2, H, W)
    flows and the centroid-pointing unit flow of the recovered (B, H, W)
    masks (cellpose's flow-error QC on the centroid field). Returns
    ((B, max_cells) errors, (B, max_cells) counts); ids >= max_cells go to
    the ignored slot 0."""
    b, h, w = labels.shape
    dev = labels.device
    flat = labels.reshape(b, -1).to(torch.int64)
    seg = torch.where((flat > 0) & (flat < max_cells), flat, torch.zeros_like(flat))
    yy = torch.arange(h, dtype=torch.float32, device=dev).repeat_interleave(w)
    xx = torch.arange(w, dtype=torch.float32, device=dev).repeat(h)
    valid = (flat > 0).float()

    def seg_sum(v):
        out = torch.zeros((b, max_cells), dtype=torch.float32, device=dev)
        return out.scatter_add_(1, seg, v)

    cnt = seg_sum(valid)
    c1 = torch.clamp(cnt, min=1)
    cy = seg_sum(yy * valid) / c1
    cx = seg_sum(xx * valid) / c1
    dy = torch.gather(cy, 1, seg) - yy
    dx = torch.gather(cx, 1, seg) - xx
    norm = torch.sqrt(dy * dy + dx * dx) + 1e-6
    gy, gx = dy / norm, dx / norm
    ey = (flows[:, 0].reshape(b, -1).float() - gy) ** 2
    ex = (flows[:, 1].reshape(b, -1).float() - gx) ** 2
    err = seg_sum((ey + ex) * valid)
    return err / c1, cnt


def flow_qc_error(labels: torch.Tensor, flows: torch.Tensor, max_cells: int = 4096):
    """Single-image ``flow_qc_error_batch``: (H, W) + (2, H, W)."""
    err, cnt = flow_qc_error_batch(labels[None], flows[None], max_cells)
    return err[0], cnt[0]


def compute_masks_batch(
    flows,
    cellprob,
    cellprob_threshold: float = 0.0,
    flow_scale: float = 5.0,
    n_iters: int = 200,
    min_size: int = 15,
    seed_threshold: float = 10.0,
    method: str = "pointer",
    device: str | torch.device | None = None,
) -> list[np.ndarray]:
    """(B, 2, H, W) network flows + (B, H, W) cellprob -> list of compact
    int32 label images. Threshold the probability, follow the flows
    (scaled down by ``flow_scale``), cluster, then drop labels under
    ``min_size`` pixels and relabel 1..K on the host. ``method``:
    'pointer' (pointer jumping over ceil(log2(n_iters)) doublings, the
    batched path) or 'euler' (``n_iters`` bilinear Euler steps).

    Tensors stay on their device; numpy inputs go to ``device`` (CUDA
    unless the caller names one)."""
    if method not in ("pointer", "euler"):
        raise ValueError(f"method must be 'pointer' or 'euler' (got {method!r})")
    if not isinstance(flows, torch.Tensor):
        dev = resolve_device(device)
        flows = torch.as_tensor(np.asarray(flows), dtype=torch.float32, device=dev)
        cellprob = torch.as_tensor(np.asarray(cellprob), dtype=torch.float32, device=dev)
    active = cellprob > cellprob_threshold
    f = flows.float() / flow_scale
    if method == "pointer":
        n_doublings = max(int(math.ceil(math.log2(max(n_iters, 2)))), 1)
        pos = follow_flows_pointer(f, active, n_doublings)
    else:
        pos = follow_flows(f, active, n_iters)
    labels = timing.fetch(masks_from_flows(pos, active, seed_threshold, 5), "masks")
    return [relabel_consecutive(lab, min_size=min_size) for lab in labels]


def compute_masks(
    flows,
    cellprob,
    cellprob_threshold: float = 0.0,
    flow_scale: float = 5.0,
    n_iters: int = 200,
    min_size: int = 15,
    seed_threshold: float = 10.0,
    method: str = "euler",
    device: str | torch.device | None = None,
) -> np.ndarray:
    """Single-image ``compute_masks_batch``: (2, H, W) flows + (H, W)
    cellprob -> compact int32 labels, by Euler integration unless
    ``method`` says 'pointer'."""
    if isinstance(flows, torch.Tensor):
        flows, cellprob = flows[None], cellprob[None]
    else:
        flows, cellprob = np.asarray(flows)[None], np.asarray(cellprob)[None]
    return compute_masks_batch(
        flows, cellprob, cellprob_threshold, flow_scale, n_iters, min_size, seed_threshold,
        method, device,
    )[0]


def relabel_consecutive(labels: np.ndarray, min_size: int = 0) -> np.ndarray:
    """Host post-pass: drop small labels, relabel to 1..K (LUT-based)."""
    labels = np.asarray(labels, dtype=np.int64)
    ids, counts = np.unique(labels[labels > 0], return_counts=True)
    keep = ids[counts >= min_size] if min_size else ids
    lut = np.zeros(int(labels.max()) + 1 if labels.size else 1, dtype=np.int32)
    lut[keep] = np.arange(1, len(keep) + 1, dtype=np.int32)
    return lut[labels]


def fill_label_holes(labels: np.ndarray) -> np.ndarray:
    """Fill interior holes of every mask (cellpose's
    fill_holes_and_remove_small_masks hole-fill half), host-side: holes are
    background regions not connected to the border; each takes the most
    common label on its one-pixel ring."""
    import scipy.ndimage as ndi

    labels = np.asarray(labels)
    structure = np.ones((3, 3), bool)
    filled = ndi.binary_fill_holes(labels > 0)
    holes = filled & (labels == 0)
    if not holes.any():
        return labels
    out = labels.copy()
    hole_labels, n = ndi.label(holes)
    for h in range(1, n + 1):
        m = hole_labels == h
        ring = ndi.binary_dilation(m, structure) & ~m
        vals = out[ring]
        vals = vals[vals > 0]
        if vals.size:
            out[m] = np.bincount(vals).argmax()
    return out


def centroid_flows(labels: np.ndarray) -> np.ndarray:
    """Ground-truth-style flows: unit vectors toward each label's centroid
    (exact for convex cells; used for tests and synthetic data)."""
    h, w = labels.shape
    flows = np.zeros((2, h, w), np.float32)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    for lab in np.unique(labels):
        if lab == 0:
            continue
        m = labels == lab
        cy, cx = yy[m].mean(), xx[m].mean()
        dy, dx = cy - yy[m], cx - xx[m]
        norm = np.sqrt(dy**2 + dx**2) + 1e-6
        flows[0][m] = dy / norm
        flows[1][m] = dx / norm
    return flows
