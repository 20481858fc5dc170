# Frozen copy of saguaro_tpu_torch/kernels/segment_cuda.py (the port's plain forms), part of the
# benchmark's reference: CUDA dispatch removed, imports made local. Not edited
# when the program changes.
"""The plain forms of the port's ``kernels/segment_cuda.py`` that the measurement
and the embedding call, and the helpers they use."""

from __future__ import annotations
import torch
from hcs_bench.reference.plain.kernels.zernike import ZERNIKE_INDEXES


def _plan(sizes: tuple[int, ...]) -> tuple[list[int], int]:
    offs, total = [], 0
    for n in sizes:
        offs.append(total)
        total += n
    return offs, total


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


def n_lanes_e(n_ch: int) -> int:
    return n_ch + 8 * len(_pairs(n_ch))


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


def pick2_out(b: int, n: int, n_ch: int, k: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """K6's output, set-major: a (K, plane) f32 buffer whose row k holds set
    k's (B, N, C) ranks from its start (plane: B * N * C rounded up to 4, so
    that every row starts 16-byte aligned), and the (B, N, C, K) view of it
    that ``seg_pick2`` and ``pick2_plain`` return, whose ``[..., k]`` is
    contiguous."""
    m = b * n * n_ch
    buf = torch.empty((k, -(-m // 4) * 4), dtype=torch.float32, device=device)
    return buf, buf[:, :m].view(k, b, n, n_ch).permute(1, 2, 3, 0)


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
