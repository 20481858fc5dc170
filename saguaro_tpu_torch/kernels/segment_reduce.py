"""Per-object segment reductions shared by the measurement families.

Index convention: output arrays are indexed by compact label id
(0 = background; slot 0 is zeroed/ignored). Labels carry a leading
site-batch dimension, (B, H, W).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from saguaro_tpu_torch.kernels.onehot_reduce import segment_matmul_sums

__all__ = ["perimeter_weight_image", "euler_streams", "euler_numbers"]


def _flat(labels: torch.Tensor, max_cells: int) -> torch.Tensor:
    """(B, H, W) -> (B, H*W) int32, routing ids >= max_cells to the
    (ignored) background bin 0 — clipping instead would silently merge
    every overflow cell into cell max_cells-1."""
    flat = labels.reshape(labels.shape[0], -1).to(torch.int32)
    return torch.where((flat > 0) & (flat < max_cells), flat, torch.zeros_like(flat))


def _shift(a: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """out[..., i, j] = a[..., i + dy, j + dx], ``fill`` outside (B, H, W)."""
    h, w = a.shape[-2:]
    p = F.pad(a, (1, 1, 1, 1), value=fill)
    return p[..., 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]


def _boundary(lab: torch.Tensor) -> torch.Tensor:
    """(B, H, W) int32 labels -> object pixels with a 4-neighbour of another
    label (the image border counts as background)."""
    return (
        (_shift(lab, -1, 0, 0) != lab)
        | (_shift(lab, 1, 0, 0) != lab)
        | (_shift(lab, 0, -1, 0) != lab)
        | (_shift(lab, 0, 1, 0) != lab)
    ) & (lab > 0)


def perimeter_weight_image(labels: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel weights of the CP 4.2.8 perimeter (exact).

    CP records regionprops' ``perimeter`` = ``skimage.measure.perimeter(
    mask, neighbourhood=4)``: border pixels (4-connected erosion residue)
    are scored by their 3x3 configuration ``1 + 2*n4 + 10*nd`` (n4/nd =
    4-adjacent / diagonal border neighbours of the same object) with
    weights 1, sqrt(2), (1+sqrt2)/2 on the attained configurations; the
    table lookup reduces to predicates on (n4, nd). Each object is scored
    on its own mask (other labels count as background).

    labels (B, H, W) -> (weights (B, H, W) f32, border (B, H, W) bool).
    """
    lab = labels.to(torch.int32)
    sh = _shift
    border = _boundary(lab)
    b8 = border.to(torch.uint8)

    def nb(dy, dx):
        # same-label border neighbour at offset (dy, dx)
        return ((sh(b8, dy, dx, 0) > 0) & (sh(lab, dy, dx, 0) == lab)).to(torch.int32)

    n4 = nb(-1, 0) + nb(1, 0) + nb(0, -1) + nb(0, 1)
    nd = nb(-1, -1) + nb(-1, 1) + nb(1, -1) + nb(1, 1)
    w1 = ((n4 == 2) | (n4 == 3)) & (nd <= 2)
    ws2 = ((n4 == 0) & (nd == 2)) | ((n4 == 1) & (nd == 3))
    wh = (n4 == 1) & ((nd == 1) | (nd == 2))
    sqrt2 = torch.tensor(math.sqrt(2.0), dtype=torch.float32)
    half = torch.tensor((1.0 + math.sqrt(2.0)) / 2.0, dtype=torch.float32)
    weights = w1.float() + ws2.float() * sqrt2.to(lab.device) + wh.float() * half.to(lab.device)
    return torch.where(border, weights, torch.zeros_like(weights)), border


def euler_streams(labels: torch.Tensor, max_cells: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The per-label sum behind ``euler_numbers``: (B, H, W) labels ->
    (slots (B, 4*(H+1)*(W+1)) int32, contributions (B, 4*(H+1)*(W+1), 1)
    f32), one stream per quad corner. A quad contributes one pattern
    evaluation for each distinct object among its 4 corners, attributed at
    that object's first corner in a, b, c, d order: +1 for one pixel of the
    object, -1 for three, -2 for a diagonal pair."""
    b = labels.shape[0]
    lab = F.pad(labels.to(torch.int32), (1, 1, 1, 1), value=0)
    corners = (lab[:, :-1, :-1], lab[:, :-1, 1:], lab[:, 1:, :-1], lab[:, 1:, 1:])
    a, bq, c, d = corners
    segs, contribs = [], []
    for r, target in enumerate(corners):
        first = target > 0
        for prev in corners[:r]:
            first = first & (prev != target)
        ta, tb, tc, td = (a == target), (bq == target), (c == target), (d == target)
        s = ta.int() + tb.int() + tc.int() + td.int()
        q1 = (s == 1) & first
        q3 = (s == 3) & first
        qd = (s == 2) & ((ta & td) | (tb & tc)) & first
        contrib = q1.float() - q3.float() - 2.0 * qd.float()
        segs.append(torch.where(first & (target < max_cells), target, 0).reshape(b, -1))
        contribs.append(contrib.reshape(b, -1))
    return torch.cat(segs, dim=1).contiguous(), torch.cat(contribs, dim=1)[..., None].contiguous()


def euler_numbers(labels: torch.Tensor, max_cells: int = 1024) -> torch.Tensor:
    """Per-object Euler number (components minus holes) by Gray's 2x2
    quad-pattern counting, 8-connectivity: E = (Q1 - Q3 - 2*QD) / 4 — the
    skimage regionprops / CP AreaShape_EulerNumber convention, counted per
    corner label (``euler_streams``) so that touching objects sharing a
    quad are each counted. The streams go through one per-label sum (K3 on
    CUDA); contributions are small integers, so the sums are exact.

    labels (B, H, W) -> (B, max_cells) f32, slot 0 set to 0.
    """
    total = segment_matmul_sums(*euler_streams(labels, max_cells), max_cells)[..., 0]
    total[:, 0] = 0.0
    return total / 4.0
