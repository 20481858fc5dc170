"""Per-cell crop extraction (port of ``saguaro_tpu/kernels/crops.py``).

The reference's regionprops + crop loop (Cellpose_GPU_s3fs.py:149-170):
per labeled cell, the integer centroid, a fixed ``BOX_SIZE`` box around it
times the cell's own binary mask, and cells whose box crosses the image
edge skipped. Plain tensor code on whatever device the inputs lie on: the
JAX package computes it with XLA's segment sums and slices, no Pallas
kernel.

``gather_crops`` cuts any list of (site, label, channel) crops from a
channel-major site batch by one gather, so the embed engine extracts one
chunk at a time and never holds the (sites x max_cells x box² x C) pool.
"""

from __future__ import annotations

import torch

__all__ = ["BOX_SIZE", "label_centroids", "in_bounds", "gather_crops", "extract_crops"]

BOX_SIZE = 200  # reference crop size (Cellpose_GPU_s3fs.py:30)


def label_centroids(labels: torch.Tensor, max_cells: int = 1024):
    """Integer centroids and pixel counts of labels 1..max_cells-1.

    labels: (H, W) or (B, H, W) integer compact labels. Returns (cy, cx,
    count), int32, each (max_cells,) or (B, max_cells); index i describes
    label i, index 0 (background, and ids >= max_cells) has count 0.

    The coordinate sums are exact (int64); the division is the
    reference's, in f32 on the f32 casts of sums and counts, then floor
    (``map(int, prop.centroid)`` truncates). Both agree wherever the
    reference's f32 sums are exact, that is every sum below 2**24.
    """
    single = labels.dim() == 2
    lab = labels[None] if single else labels
    b, h, w = lab.shape
    dev = lab.device
    lab = lab.to(torch.int64)
    # ids >= max_cells go to the ignored background bin, never to cell max_cells-1
    seg = torch.where((lab > 0) & (lab < max_cells), lab, 0)
    seg = (seg + torch.arange(b, device=dev)[:, None, None] * max_cells).reshape(-1)
    # as the reference, only labeled pixels are summed (bin 0's centroid
    # comes from the ids >= max_cells alone)
    fg = (lab > 0).to(torch.int64)
    yy = torch.arange(h, device=dev)[:, None] * fg
    xx = torch.arange(w, device=dev)[None, :] * fg
    n = b * max_cells

    def sums(v):
        return torch.zeros(n, dtype=torch.int64, device=dev).index_add_(0, seg, v.reshape(-1))

    cnt, sy, sx = sums(fg), sums(yy), sums(xx)
    cnt, sy, sx = (t.view(b, max_cells) for t in (cnt, sy, sx))
    cnt[:, 0] = 0
    denom = cnt.clamp(min=1).to(torch.float32)
    cy = torch.floor(sy.to(torch.float32) / denom).to(torch.int32)
    cx = torch.floor(sx.to(torch.float32) / denom).to(torch.int32)
    cnt = cnt.to(torch.int32)
    if single:
        return cy[0], cx[0], cnt[0]
    return cy, cx, cnt


def in_bounds(cy, cx, h: int, w: int, box: int = BOX_SIZE):
    """The reference's edge rule (Cellpose_GPU_s3fs.py:162): the box around
    (cy, cx) lies inside the (h, w) image, ``cy - half >= 0`` and
    ``cy + half <= h`` (and the same for x)."""
    half = box // 2
    return (cy - half >= 0) & (cy + half <= h) & (cx - half >= 0) & (cx + half <= w)


def gather_crops(images_chw: torch.Tensor, labels: torch.Tensor, site, lab, ch, cy, cx,
                 box: int = BOX_SIZE) -> torch.Tensor:
    """Masked crops of a site batch: (k, box, box) f32, crop j the window of
    channel ``ch[j]`` of site ``site[j]`` around (``cy[j]``, ``cx[j]``)
    times the mask of label ``lab[j]``.

    images_chw: (B, C, H, W) f32; labels: (B, H, W); the five index
    tensors (k,) on the same device. The window's top-left corner is
    ``clip(c - box // 2, 0, side - box)``, as the reference's."""
    h, w = labels.shape[-2:]
    half = box // 2
    d = torch.arange(box, device=labels.device)
    rows = ((cy.long() - half).clamp(0, h - box)[:, None] + d)[:, :, None]
    cols = ((cx.long() - half).clamp(0, w - box)[:, None] + d)[:, None, :]
    s = site.long()[:, None, None]
    img = images_chw[s, ch.long()[:, None, None], rows, cols]
    mask = labels[s, rows, cols] == lab.to(labels.dtype)[:, None, None]
    return img * mask


def extract_crops(image: torch.Tensor, labels: torch.Tensor, max_cells: int = 1024,
                  box: int = BOX_SIZE):
    """Masked fixed-size crops around every cell centroid of one site.

    image: (H, W, C); labels: (H, W) compact labels. Returns (crops
    (max_cells, box, box, C) f32, zero where not valid; valid
    (max_cells,) bool; coords (max_cells, 2) int32 [cy, cx]). Validity is
    a present label whose box passes the edge rule."""
    h, w, c = image.shape
    if box > h or box > w:
        raise ValueError(f"a {box}-pixel box does not fit a {h} x {w} image")
    cy, cx, cnt = label_centroids(labels, max_cells)
    valid = (cnt > 0) & in_bounds(cy, cx, h, w, box)
    dev = image.device
    lab = torch.arange(max_cells, device=dev).repeat_interleave(c)
    chan = torch.arange(c, device=dev).repeat(max_cells)
    crops = gather_crops(
        image.float().permute(2, 0, 1)[None], labels[None], torch.zeros_like(lab), lab, chan,
        cy.repeat_interleave(c), cx.repeat_interleave(c), box,
    )
    crops = crops.view(max_cells, c, box, box).permute(0, 2, 3, 1)
    crops = crops * valid[:, None, None, None]
    return crops, valid, torch.stack([cy, cx], dim=-1)
