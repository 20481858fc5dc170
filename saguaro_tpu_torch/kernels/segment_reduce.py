"""Per-object segment reductions shared by the measurement families, and
the reference's per-family measurement API: ``segment_stats``,
``intensity_features``, ``shape_features`` and ``correlation_features``
(CP MeasureObjectIntensity, AreaShape and MeasureColocalization core sets,
one channel or pair at a time; ``fused_object_features`` computes the same
families in its lane scans, and these are its oracles, as in the
reference).

Plain per-label sums go through ``segment_matmul_sums`` (K3 on CUDA); min,
max and argmax through ``scatter_reduce``; per-pixel reads of a per-label
table are plain gathers, as the reference's ``jnp.take``. Second moments
are summed over centred values (two passes), as in the reference.

Index convention: output arrays are indexed by compact label id
(0 = background; slot 0 is zeroed/ignored). Labels carry a leading
site-batch dimension, (B, H, W); images (B, H, W); outputs (B, max_cells).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from saguaro_tpu_torch.kernels.onehot_reduce import segment_matmul_sums

__all__ = [
    "segment_stats",
    "intensity_features",
    "shape_features",
    "perimeter_weight_image",
    "correlation_features",
    "euler_streams",
    "euler_numbers",
]

_BIG = 3.4e38


def _flat(labels: torch.Tensor, max_cells: int) -> torch.Tensor:
    """(B, H, W) -> (B, H*W) int32, routing ids >= max_cells to the
    (ignored) background bin 0 — clipping instead would silently merge
    every overflow cell into cell max_cells-1."""
    flat = labels.reshape(labels.shape[0], -1).to(torch.int32)
    return torch.where((flat > 0) & (flat < max_cells), flat, torch.zeros_like(flat))


def _take(table: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """(B, max_cells) or (B, max_cells, K) per-label values -> per-pixel
    (B, N) or (B, N, K): a plain gather, as the reference's ``jnp.take``."""
    idx = seg.long()
    if table.dim() == 2:
        return torch.gather(table, 1, idx)
    return torch.gather(table, 1, idx[..., None].expand(-1, -1, table.shape[2]))


def _segment_reduce(vals: torch.Tensor, seg: torch.Tensor, max_cells: int, op: str):
    """(B, N) or (B, N, K) values + (B, N) slots -> (B, max_cells) or
    (B, max_cells, K) per-slot min or max (``op`` "amin" / "amax"); slots no
    pixel reaches hold the identity (+-inf), as ``jax.ops.segment_min/max``
    return. No Pallas kernel computes these."""
    fill = math.inf if op == "amin" else -math.inf
    out = torch.full((vals.shape[0], max_cells, *vals.shape[2:]), fill, dtype=vals.dtype,
                     device=vals.device)
    idx = seg.long() if vals.dim() == 2 else seg.long()[..., None].expand_as(vals)
    return out.scatter_reduce_(1, idx, vals, op, include_self=False)


def _coords(b: int, h: int, w: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Row and column of every pixel, (B, H*W) f32 each."""
    y = torch.arange(h, dtype=torch.float32, device=device).repeat_interleave(w).expand(b, -1)
    x = torch.arange(w, dtype=torch.float32, device=device).repeat(h).expand(b, -1)
    return y, x


def segment_stats(values: torch.Tensor, labels: torch.Tensor, max_cells: int = 1024):
    """(count, sum, sum of squares, min, max) per label of one value image:
    values, labels (B, H, W) -> five (B, max_cells) f32. Pixels of ids >=
    max_cells count in slot 0; labels no pixel has get min +inf, max -inf."""
    b = labels.shape[0]
    seg = _flat(labels, max_cells)
    v = values.reshape(b, -1).float()
    inside = labels.reshape(b, -1) > 0
    ones = inside.float()
    sums = segment_matmul_sums(seg, torch.stack([ones, v * ones, v * v * ones], dim=-1), max_cells)
    big = torch.full_like(v, _BIG)
    vmin = _segment_reduce(torch.where(inside, v, big), seg, max_cells, "amin")
    vmax = _segment_reduce(torch.where(inside, v, -big), seg, max_cells, "amax")
    return sums[..., 0], sums[..., 1], sums[..., 2], vmin, vmax


def intensity_features(image: torch.Tensor, labels: torch.Tensor, max_cells: int = 1024):
    """CP MeasureObjectIntensity core set of one channel: image, labels
    (B, H, W) -> {column: (B, max_cells)}: IntegratedIntensity,
    MeanIntensity, StdIntensity, MinIntensity, MaxIntensity,
    MassDisplacement (binary centroid to intensity-weighted centroid),
    CenterMassIntensity_Y/X and MaxIntensity_Y/X (the first pixel in raster
    order at the object's maximum). The variance sums centred values."""
    b, h, w = labels.shape
    seg = _flat(labels, max_cells)
    inside_b = labels.reshape(b, -1) > 0
    inside = inside_b.float()
    vr = image.reshape(b, -1).float()
    v = vr * inside
    yf, xf = _coords(b, h, w, image.device)
    payload = torch.stack([inside, v, yf * inside, xf * inside, yf * v, xf * v], dim=-1)
    sums = segment_matmul_sums(seg, payload, max_cells)
    cnt, s, sy, sx, wy, wx = (sums[..., i] for i in range(6))
    denom = torch.clamp(cnt, min=1.0)
    mean = s / denom
    vc = (vr - _take(mean, seg)) * inside
    var = segment_matmul_sums(seg, (vc * vc)[..., None], max_cells)[..., 0] / denom
    var = torch.clamp(var, min=0.0)

    big = torch.full_like(vr, _BIG)
    vmin = _segment_reduce(torch.where(inside_b, vr, big), seg, max_cells, "amin")
    vmax = _segment_reduce(torch.where(inside_b, vr, -big), seg, max_cells, "amax")
    sdenom = torch.clamp(s, min=1e-12)
    disp = torch.sqrt((sy / denom - wy / sdenom) ** 2 + (sx / denom - wx / sdenom) ** 2)
    at_max = inside_b & (vr >= _take(vmax, seg))
    idx = torch.arange(h * w, dtype=torch.float32, device=image.device).expand(b, -1)
    pick = _segment_reduce(torch.where(at_max, idx, torch.full_like(idx, float(h * w))), seg,
                        max_cells, "amin")
    pick_i = torch.clamp(pick, 0, h * w - 1).to(torch.int32)
    max_y = torch.div(pick_i, w, rounding_mode="floor").float()
    max_x = (pick_i % w).float()
    zero = cnt <= 0

    def z(a):
        return torch.where(zero, torch.zeros_like(a), a)

    return {
        "IntegratedIntensity": z(s),
        "MeanIntensity": z(mean),
        "StdIntensity": z(torch.sqrt(var)),
        "MinIntensity": z(vmin),
        "MaxIntensity": z(vmax),
        "MassDisplacement": z(disp),
        "CenterMassIntensity_Y": z(wy / sdenom),
        "CenterMassIntensity_X": z(wx / sdenom),
        "MaxIntensity_Y": z(max_y),
        "MaxIntensity_X": z(max_x),
    }


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


def shape_features(labels: torch.Tensor, max_cells: int = 1024):
    """CP AreaShape core set: labels (B, H, W) -> {column: (B, max_cells)}:
    Area, Perimeter (CP 4.2.8's, ``perimeter_weight_image``), Center_Y/X,
    Major/MinorAxisLength, Eccentricity, Orientation, Extent, FormFactor,
    Compactness, BoundingBoxArea and the box's minima and maxima. The
    second moments sum coordinates centred on each object's centroid."""
    b, h, w = labels.shape
    seg = _flat(labels, max_cells)
    inside = labels.reshape(b, -1) > 0
    ones = inside.float()
    yf, xf = _coords(b, h, w, labels.device)
    pw, _ = perimeter_weight_image(labels)
    payload = torch.stack([ones, yf * ones, xf * ones, pw.reshape(b, -1)], dim=-1)
    sums = segment_matmul_sums(seg, payload, max_cells)
    area, sy, sx, perim = (sums[..., i] for i in range(4))
    denom = torch.clamp(area, min=1.0)
    cy, cx = sy / denom, sx / denom
    yc = (yf - _take(cy, seg)) * ones
    xc = (xf - _take(cx, seg)) * ones
    sums2 = segment_matmul_sums(seg, torch.stack([yc * yc, xc * xc, yc * xc], dim=-1), max_cells)
    # central second moments (pixel-centre convention: +1/12 an axis)
    muyy = sums2[..., 0] / denom + 1.0 / 12.0
    muxx = sums2[..., 1] / denom + 1.0 / 12.0
    muxy = sums2[..., 2] / denom
    common = torch.sqrt(torch.clamp((muyy - muxx) ** 2 + 4 * muxy**2, min=0.0))
    l1 = (muyy + muxx + common) / 2.0
    l2 = (muyy + muxx - common) / 2.0
    major = 4.0 * torch.sqrt(torch.clamp(l1, min=0.0))
    minor = 4.0 * torch.sqrt(torch.clamp(l2, min=0.0))
    ecc = torch.sqrt(torch.clamp(1.0 - (l2 / torch.clamp(l1, min=1e-12)), min=0.0))
    orientation = 0.5 * torch.atan2(2.0 * muxy, muxx - muyy)

    big = torch.full_like(yf, 1e9)
    ymin = _segment_reduce(torch.where(inside, yf, big), seg, max_cells, "amin")
    ymax = _segment_reduce(torch.where(inside, yf, -big), seg, max_cells, "amax")
    xmin = _segment_reduce(torch.where(inside, xf, big), seg, max_cells, "amin")
    xmax = _segment_reduce(torch.where(inside, xf, -big), seg, max_cells, "amax")
    bbox_area = torch.clamp(ymax - ymin + 1, min=0) * torch.clamp(xmax - xmin + 1, min=0)
    extent = area / torch.clamp(bbox_area, min=1.0)
    form = 4.0 * math.pi * area / torch.clamp(perim * perim, min=1e-12)
    compact = torch.clamp(perim * perim, min=0.0) / torch.clamp(4.0 * math.pi * area, min=1e-12)
    zero = area <= 0

    def z(a):
        return torch.where(zero, torch.zeros_like(a), a)

    return {
        "Area": z(area),
        "Perimeter": z(perim),
        "Center_Y": z(cy),
        "Center_X": z(cx),
        "MajorAxisLength": z(major),
        "MinorAxisLength": z(minor),
        "Eccentricity": z(ecc),
        "Orientation": z(orientation),
        "Extent": z(extent),
        "FormFactor": z(form),
        "Compactness": z(compact),
        "BoundingBoxArea": z(bbox_area),
        "BoundingBoxMinimum_Y": z(ymin),
        "BoundingBoxMaximum_Y": z(ymax),
        "BoundingBoxMinimum_X": z(xmin),
        "BoundingBoxMaximum_X": z(xmax),
    }


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


def correlation_features(
    ch_a: torch.Tensor, ch_b: torch.Tensor, labels: torch.Tensor, max_cells: int = 1024
):
    """CP MeasureColocalization core of one channel pair: the Pearson
    correlation and least-squares slope of b on a inside each object, from
    centred sums. ch_a, ch_b, labels (B, H, W) -> {"Correlation", "Slope"}
    each (B, max_cells); objects of at most one pixel give 0."""
    b = labels.shape[0]
    seg = _flat(labels, max_cells)
    inside = (labels.reshape(b, -1) > 0).float()
    a = ch_a.reshape(b, -1).float() * inside
    c = ch_b.reshape(b, -1).float() * inside
    sums = segment_matmul_sums(seg, torch.stack([inside, a, c], dim=-1), max_cells)
    n, sa, sb = sums[..., 0], sums[..., 1], sums[..., 2]
    denom = torch.clamp(n, min=1.0)
    ac = (a - _take(sa / denom, seg)) * inside
    bc = (c - _take(sb / denom, seg)) * inside
    sums2 = segment_matmul_sums(seg, torch.stack([ac * ac, bc * bc, ac * bc], dim=-1), max_cells)
    va = torch.clamp(sums2[..., 0] / denom, min=0.0)
    vb = torch.clamp(sums2[..., 1] / denom, min=0.0)
    cov = sums2[..., 2] / denom
    corr = cov / torch.clamp(torch.sqrt(va * vb), min=1e-12)
    slope = cov / torch.clamp(va, min=1e-12)
    zero = n <= 1
    return {
        "Correlation": torch.where(zero, torch.zeros_like(corr), corr),
        "Slope": torch.where(zero, torch.zeros_like(slope), slope),
    }
