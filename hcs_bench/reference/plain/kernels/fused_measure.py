# Frozen copy of saguaro_tpu_torch/kernels/fused_measure.py (the port's plain forms), part of the
# benchmark's reference: CUDA dispatch removed, imports made local. Not edited
# when the program changes.
"""Fused per-object measurement — the payload-sum families in a fixed pass
structure per object set (port of ``saguaro_tpu/kernels/fused_measure.py``):

  A   one lane scan (K4): areas, centroid sums, boundary counts, perimeter,
      channel sums, intensity-weighted coordinates, edge sums, uncentred
      quadratics
  B   one segment max + one segment min (multi-lane scatters): bboxes,
      channel min/max, edge min/max, rmax and the max-intensity pixel, after
      one per-pixel gather (K2) of centroids and channel maxima
  C   one lane scan (K4) over a gathered per-label table: centred and bbox
      moment products, Zernike re/im, centred quadratics, edge quadratics;
      the radial-distribution lanes of the reference's pass C (ring and
      ring-by-wedge counts and channel sums) run as one keyed sum over
      each pixel's packed ring/wedge code (K4 radial): a pixel adds to its
      own bin only, and the ring sums are the sums of their 8 wedges

All tensors carry a leading site-batch dimension: image (B, H, W, C),
labels (B, H, W); every output is (B, max_cells, ...).
"""

from __future__ import annotations

import math

import torch

from hcs_bench.reference.plain.kernels import segment_cuda as sc
from hcs_bench.reference.plain.kernels.onehot_reduce import mxu_take_t
from hcs_bench.reference.plain.kernels.segment_reduce import _flat, _segment_reduce, perimeter_weight_image
from hcs_bench.reference.plain.kernels.zernike import ZERNIKE_INDEXES, _radial_coeffs

__all__ = ["fused_object_features"]

_ORDERS = [(p, q) for p in range(4) for q in range(4)]


def _lane_scan_a(labels, image, pweight, border, max_cells, with_edge):
    """Pass A lane sums: K4 for CUDA tensors, the plain form for CPU ones."""
    return sc.lane_sums_a_plain(labels, image, pweight, border, max_cells, with_edge)


def _lane_scan_c(labels, image, border, table, zcoef, max_cells, moments, zernike, edge):
    """Pass C lane sums: K4 for CUDA tensors, the plain form for CPU ones."""
    return sc.lane_sums_c_plain(
        labels, image, border, table, zcoef, max_cells, moments, zernike, edge
    )


def _radial_sums(labels, codes, vr, max_cells, n_codes):
    """Per-(label, bin) counts and channel sums: K4 radial for CUDA
    tensors, the plain form for CPU ones."""
    return sc.radial_sums_plain(labels, codes, vr, max_cells, n_codes)


def fused_object_features(
    image: torch.Tensor,
    labels: torch.Tensor,
    max_cells: int = 1024,
    n_rings: int = 4,
    with_moments: bool = True,
    with_zernike: bool = True,
    with_edge: bool = True,
    with_radial: bool = True,
    ring_wedge: torch.Tensor | None = None,
):
    """(B, H, W, C) image + (B, H, W) labels -> dict of family results:

    ``shape``     AreaShape core set, each (B, max_cells)
    ``stats``     (cnt, vmin (B, max_cells, C), vmax (B, max_cells, C))
    ``moments``   spatial/central/normalized/Hu/inertia      [with_moments]
    ``zernike``   (B, max_cells, 30) magnitudes              [with_zernike]
    ``intensity`` MeasureObjectIntensity set, each (B, max_cells, C)
    ``corr``      {(a, b): (corr, slope)}
    ``coloc_quad``{(a, b): (overlap, K1, K2)}
    ``edge``      edge-intensity set                         [with_edge]
    ``radial``    FracAtD / MeanFrac / RadialCV, each
                  (B, max_cells, n_rings, C)                 [with_radial]

    ``ring_wedge``: optional (B, H, W) int32 packed CP ring/wedge code from
    ``radial.cp_ring_wedge`` (ring*8 + wedge; 8*n_rings = excluded). When
    given, the radial lanes bin by CP's normalized edge + centre distance;
    otherwise by the centroid distance over the object's largest one.
    """
    dev = image.device
    b, h, w, n_ch = image.shape
    image = image.float().contiguous()
    lab32 = labels.to(torch.int32).contiguous()
    seg = _flat(lab32, max_cells)
    inside_m = lab32.reshape(b, h * w) > 0
    yf = torch.arange(h, dtype=torch.float32, device=dev).repeat_interleave(w)
    xf = torch.arange(w, dtype=torch.float32, device=dev).repeat(h)
    vr = image.reshape(b, h * w, n_ch)

    pweight, border = perimeter_weight_image(lab32)
    boundary_m = border.reshape(b, h * w)
    border_u8 = border.to(torch.uint8).contiguous()

    # ---------------- pass A: all linear sums ----------------
    pairs = [(a, c) for a in range(n_ch) for c in range(a + 1, n_ch)]
    sums_a = _lane_scan_a(lab32, image, pweight.contiguous(), border_u8, max_cells, with_edge)
    cnt, sy, sx, edge_cnt, perim = (sums_a[..., i] for i in range(5))
    o = 5
    s = sums_a[..., o : o + n_ch]
    wy = sums_a[..., o + n_ch : o + 2 * n_ch]
    wx = sums_a[..., o + 2 * n_ch : o + 3 * n_ch]
    o += 3 * n_ch
    edge_s = sums_a[..., o : o + n_ch] if with_edge else None
    if with_edge:
        o += n_ch
    sum_vv = sums_a[..., o : o + n_ch]
    sum_vw = sums_a[..., o + n_ch : o + n_ch + len(pairs)]

    denom = torch.clamp(cnt, min=1.0)
    cy, cx = sy / denom, sx / denom
    mean = s / denom[..., None]
    zero = cnt <= 0

    # ---------------- pass B: segment max, gather, segment min ----------------
    big = torch.tensor(3.4e38, dtype=torch.float32, device=dev)
    ins = inside_m[..., None]
    max_lanes = [
        torch.where(inside_m, yf, -big)[..., None],
        torch.where(inside_m, xf, -big)[..., None],
        torch.where(ins, vr, -big),
    ]
    if with_edge:
        max_lanes.append(torch.where(boundary_m[..., None], vr, -big))
    maxs = _segment_reduce(torch.cat(max_lanes, dim=-1), seg, max_cells, "amax")
    ymax, xmax = maxs[..., 0], maxs[..., 1]
    vmax = maxs[..., 2 : 2 + n_ch]
    edge_vmax = maxs[..., 2 + n_ch :] if with_edge else None

    g0 = mxu_take_t(torch.cat([cy[..., None], cx[..., None], vmax], dim=-1), seg, max_cells)
    dy = yf - g0[:, 0]
    dx = xf - g0[:, 1]
    dist = sc.sqrt32(sc.fma32(dy, dy, dx * dx))  # the reference's contraction
    # tolerant max-pixel test, as the reference (its gather was ~1 ulp off;
    # this one is exact, and the tolerance is far below one grey level)
    g0v = g0[:, 2:].transpose(1, 2)
    at_max = ins & (vr >= g0v - (g0v.abs() * 4e-6 + 1e-12))
    idxf = torch.arange(h * w, dtype=torch.float32, device=dev)
    n_pix = torch.tensor(float(h * w), dtype=torch.float32, device=dev)
    min_lanes = [
        torch.where(inside_m, yf, big)[..., None],
        torch.where(inside_m, xf, big)[..., None],
        torch.where(ins, vr, big),
        torch.where(inside_m, -dist, torch.ones_like(dist))[..., None],
        torch.where(at_max, idxf[:, None], n_pix),
    ]
    if with_edge:
        min_lanes.append(torch.where(boundary_m[..., None], vr, big))
    mins = _segment_reduce(torch.cat(min_lanes, dim=-1), seg, max_cells, "amin")
    ymin, xmin = mins[..., 0], mins[..., 1]
    vmin = mins[..., 2 : 2 + n_ch]
    o_c0 = 2 + n_ch
    rmax = -mins[..., o_c0]
    pick_i = torch.clamp(mins[..., o_c0 + 1 : o_c0 + 1 + n_ch], 0, h * w - 1).to(torch.int64)
    max_y = torch.div(pick_i, w, rounding_mode="floor").float()
    max_x = (pick_i % w).float()
    edge_vmin = mins[..., o_c0 + 1 + n_ch :] if with_edge else None

    # ---------------- pass C: centred power products ----------------
    central_orders = [pq for pq in _ORDERS if pq != (0, 0)]
    spec_c: list = [("central", 15)]
    if with_moments:
        spec_c.append(("bbox", 15))
    if with_zernike:
        spec_c.append(("zernike", 60))
    spec_c.append(("var", n_ch))
    if pairs:
        spec_c.append(("cross", len(pairs)))
    if with_edge:
        edge_denom = torch.clamp(edge_cnt, min=1.0)
        edge_mean = edge_s / edge_denom[..., None]
        spec_c.append(("edge_var", n_ch))
    zf = torch.zeros_like(ymin)
    t_cols = [cy[..., None], cx[..., None]]
    if with_moments:
        t_cols += [torch.where(zero, zf, ymin)[..., None], torch.where(zero, zf, xmin)[..., None]]
    if with_zernike:
        t_cols.append(rmax[..., None])
    t_cols.append(mean)
    if with_edge:
        t_cols.append(edge_mean)
    tables_c = torch.cat(t_cols, dim=-1).contiguous()
    zcoef = torch.tensor(_radial_coeffs(), dtype=torch.float32, device=dev)
    sums_c = _lane_scan_c(
        lab32, image, border_u8, tables_c, zcoef, max_cells,
        with_moments, with_zernike, with_edge,
    )
    parts = {}
    off = 0
    for name, n in spec_c:
        parts[name] = sums_c[..., off : off + n]
        off += n

    # ---------------- radial rings and wedges (K4 radial) ----------------
    radial_out = None
    if with_radial:
        if ring_wedge is not None:
            codes = ring_wedge.reshape(b, h * w).to(torch.int32).contiguous()
        else:
            g_r = mxu_take_t(rmax, seg, max_cells)[:, 0]
            inv_rmax = 1.0 / torch.clamp(g_r, min=1e-6)
            ring = torch.clamp((dist * inv_rmax * n_rings).to(torch.int32), 0, n_rings - 1)
            # RadialCV octant wedges (measureobjectintensitydistribution)
            wedge = (
                (dy > 0).to(torch.int32) + 2 * (dx > 0).to(torch.int32)
                + 4 * (dy.abs() > dx.abs()).to(torch.int32)
            )
            codes = (ring * 8 + wedge).contiguous()
        rcv = _radial_sums(
            lab32.reshape(b, h * w), codes, vr.contiguous(), max_cells, 8 * n_rings
        ).view(b, max_cells, n_rings, 8, 1 + n_ch)
        ring_sums = rcv.sum(dim=3)
        ring_cnt = ring_sums[..., 0]
        ring_int = ring_sums[..., 1:]
        total_int = torch.clamp(ring_int.sum(dim=2, keepdim=True), min=1e-12)
        frac_at_d = ring_int / total_int
        # denominator = pixels in any ring (CP's good mask: all of Area for
        # centroid binning, without race-lost pixels for CP binning)
        pix_frac = ring_cnt / torch.clamp(ring_cnt.sum(dim=2, keepdim=True), min=1.0)
        mean_frac = frac_at_d / torch.clamp(pix_frac[..., None], min=1e-12)
        zr = zero[..., None, None]
        zeros_r = torch.zeros_like(frac_at_d)
        radial_out = {
            "FracAtD": torch.where(zr, zeros_r, frac_at_d),
            "MeanFrac": torch.where(zr, zeros_r, mean_frac),
        }
        # RadialCV: per (object, ring) coefficient of variation of the 8
        # wedges' mean intensities over the populated wedges (population
        # std); objects and rings with no populated wedge give 0
        wcnt = rcv[..., 0]
        wsum = rcv[..., 1:]
        present = wcnt > 0
        wmean = torch.where(
            present[..., None], wsum / torch.clamp(wcnt[..., None], min=1.0),
            torch.zeros_like(wsum),
        )
        npres = torch.clamp(present.sum(dim=3), min=1)[..., None].float()
        mean_w = wmean.sum(dim=3) / npres
        var_w = torch.where(
            present[..., None], (wmean - mean_w[..., None, :]) ** 2, torch.zeros_like(wmean)
        ).sum(dim=3) / npres
        any_w = present.sum(dim=3)[..., None] > 0
        radial_out["RadialCV"] = torch.where(
            any_w & (mean_w > 0) & ~zr,
            torch.sqrt(var_w) / torch.clamp(mean_w, min=1e-30),
            torch.zeros_like(mean_w),
        )

    # ---------------- assemble family outputs ----------------
    zt = torch.zeros_like(cnt)

    def z(a):
        return torch.where(zero, zt, a)

    def z2(a):
        return torch.where(zero[..., None], torch.zeros_like(a), a)

    central = {pq: parts["central"][..., i] for i, pq in enumerate(central_orders)}
    central[(0, 0)] = cnt

    muyy = central[(2, 0)] / denom + 1.0 / 12.0
    muxx = central[(0, 2)] / denom + 1.0 / 12.0
    muxy = central[(1, 1)] / denom
    common = torch.sqrt(torch.clamp((muyy - muxx) ** 2 + 4 * muxy**2, min=0.0))
    l1 = (muyy + muxx + common) / 2.0
    l2 = (muyy + muxx - common) / 2.0
    bbox_area = torch.clamp(ymax - ymin + 1, min=0) * torch.clamp(xmax - xmin + 1, min=0)
    pi = math.pi
    shape = {
        "Area": z(cnt),
        "Perimeter": z(perim),
        "Center_Y": z(cy),
        "Center_X": z(cx),
        "MajorAxisLength": z(4.0 * torch.sqrt(torch.clamp(l1, min=0.0))),
        "MinorAxisLength": z(4.0 * torch.sqrt(torch.clamp(l2, min=0.0))),
        "Eccentricity": z(
            torch.sqrt(torch.clamp(1.0 - (l2 / torch.clamp(l1, min=1e-12)), min=0.0))
        ),
        "Orientation": z(0.5 * torch.atan2(2.0 * muxy, muxx - muyy)),
        "Extent": z(cnt / torch.clamp(bbox_area, min=1.0)),
        "FormFactor": z(4.0 * pi * cnt / torch.clamp(perim * perim, min=1e-12)),
        "Compactness": z(
            torch.clamp(perim * perim, min=0.0) / torch.clamp(4.0 * pi * cnt, min=1e-12)
        ),
        "BoundingBoxArea": z(bbox_area),
        "BoundingBoxMinimum_Y": z(ymin),
        "BoundingBoxMaximum_Y": z(ymax),
        "BoundingBoxMinimum_X": z(xmin),
        "BoundingBoxMaximum_X": z(xmax),
    }

    moments_out = None
    if with_moments:
        spatial = {pq: parts["bbox"][..., i] for i, pq in enumerate(central_orders)}
        spatial[(0, 0)] = cnt
        mo: dict[str, torch.Tensor] = {}
        for p, q in _ORDERS:
            mo[f"SpatialMoment_{p}_{q}"] = z(spatial[(p, q)])
        for p, q in _ORDERS:
            mo[f"CentralMoment_{p}_{q}"] = z(central[(p, q)])
        nu = {}
        for p, q in _ORDERS:
            nu[(p, q)] = central[(p, q)] / torch.pow(denom, 1.0 + (p + q) / 2.0)
            mo[f"NormalizedMoment_{p}_{q}"] = z(nu[(p, q)])
        n20, n02, n11 = nu[(2, 0)], nu[(0, 2)], nu[(1, 1)]
        n30, n03, n21, n12 = nu[(3, 0)], nu[(0, 3)], nu[(2, 1)], nu[(1, 2)]
        hu = [
            n20 + n02,
            (n20 - n02) ** 2 + 4 * n11**2,
            (n30 - 3 * n12) ** 2 + (3 * n21 - n03) ** 2,
            (n30 + n12) ** 2 + (n21 + n03) ** 2,
            (n30 - 3 * n12) * (n30 + n12)
            * ((n30 + n12) ** 2 - 3 * (n21 + n03) ** 2)
            + (3 * n21 - n03) * (n21 + n03)
            * (3 * (n30 + n12) ** 2 - (n21 + n03) ** 2),
            (n20 - n02) * ((n30 + n12) ** 2 - (n21 + n03) ** 2)
            + 4 * n11 * (n30 + n12) * (n21 + n03),
            (3 * n21 - n03) * (n30 + n12)
            * ((n30 + n12) ** 2 - 3 * (n21 + n03) ** 2)
            - (n30 - 3 * n12) * (n21 + n03)
            * (3 * (n30 + n12) ** 2 - (n21 + n03) ** 2),
        ]
        for i, val in enumerate(hu):
            mo[f"HuMoment_{i}"] = z(val)
        t00 = central[(2, 0)] / denom
        t11 = central[(0, 2)] / denom
        t01 = -central[(1, 1)] / denom
        mo["InertiaTensor_0_0"] = z(t00)
        mo["InertiaTensor_0_1"] = z(t01)
        mo["InertiaTensor_1_0"] = z(t01)
        mo["InertiaTensor_1_1"] = z(t11)
        tr = (t00 + t11) / 2.0
        det = torch.sqrt(torch.clamp(((t00 - t11) / 2.0) ** 2 + t01**2, min=0.0))
        mo["InertiaTensorEigenvalues_0"] = z(tr + det)
        mo["InertiaTensorEigenvalues_1"] = z(tr - det)
        mo["EquivalentDiameter"] = z(torch.sqrt(4.0 * cnt / pi))
        moments_out = mo

    zernike_out = None
    if with_zernike:
        sre = parts["zernike"][..., :30]
        sim = parts["zernike"][..., 30:]
        mag = torch.sqrt(sre * sre + sim * sim)
        ns = torch.tensor([n for n, _ in ZERNIKE_INDEXES], dtype=torch.float32, device=dev)
        norm = (ns + 1.0) / pi / torch.clamp(cnt[..., None], min=1.0)
        zernike_out = torch.where(cnt[..., None] > 0, mag * norm, torch.zeros_like(mag))

    var = torch.clamp(parts["var"] / denom[..., None], min=0.0)
    sdenom = torch.clamp(s, min=1e-12)
    disp = torch.sqrt(
        ((sy / denom)[..., None] - wy / sdenom) ** 2
        + ((sx / denom)[..., None] - wx / sdenom) ** 2
    )
    intensity = {
        "IntegratedIntensity": z2(s),
        "MeanIntensity": z2(mean),
        "StdIntensity": z2(torch.sqrt(var)),
        "MinIntensity": z2(vmin),
        "MaxIntensity": z2(vmax),
        "MassDisplacement": z2(disp),
        "CenterMassIntensity_Y": z2(wy / sdenom),
        "CenterMassIntensity_X": z2(wx / sdenom),
        "MaxIntensity_Y": z2(max_y),
        "MaxIntensity_X": z2(max_x),
    }
    zero1 = cnt <= 1
    corr = {}
    for i, (a, c) in enumerate(pairs):
        cov = parts["cross"][..., i] / denom
        cc = cov / torch.clamp(torch.sqrt(var[..., a] * var[..., c]), min=1e-12)
        sl = cov / torch.clamp(var[..., a], min=1e-12)
        corr[(a, c)] = (torch.where(zero1, zt, cc), torch.where(zero1, zt, sl))

    # CP MeasureColocalization Overlap / K1 / K2 from pass A's uncentred
    # quadratics (scale-invariant, so raw values stand in for CP's [0,1])
    coloc_quad = {}
    for i, (a, c) in enumerate(pairs):
        pdt = sum_vw[..., i]
        fsq, ssq = sum_vv[..., a], sum_vv[..., c]
        den_o = torch.sqrt(fsq * ssq)
        coloc_quad[(a, c)] = (
            torch.where(den_o > 0, pdt / torch.clamp(den_o, min=1e-30), zt),
            torch.where(fsq > 0, pdt / torch.clamp(fsq, min=1e-30), zt),
            torch.where(ssq > 0, pdt / torch.clamp(ssq, min=1e-30), zt),
        )

    edge_out = None
    if with_edge:
        e_zero = (edge_cnt <= 0)[..., None]

        def ze(a):
            return torch.where(e_zero, torch.zeros_like(a), a)

        e_var = torch.clamp(parts["edge_var"] / edge_denom[..., None], min=0.0)
        edge_out = {
            "IntegratedIntensityEdge": ze(edge_s),
            "MeanIntensityEdge": ze(edge_mean),
            "StdIntensityEdge": ze(torch.sqrt(e_var)),
            "MinIntensityEdge": ze(edge_vmin),
            "MaxIntensityEdge": ze(edge_vmax),
        }

    return {
        "shape": shape,
        "stats": (cnt, vmin, vmax),
        "moments": moments_out,
        "zernike": zernike_out,
        "intensity": intensity,
        "corr": corr,
        "coloc_quad": coloc_quad,
        "edge": edge_out,
        "radial": radial_out,
    }
