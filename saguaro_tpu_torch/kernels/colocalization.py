"""Per-object thresholded colocalization, CP 4.2.8 MeasureColocalization
(port of ``saguaro_tpu/kernels/colocalization.py``).

Correlation, Slope, Overlap and K ride the fused lane scans
(``fused_measure``); this module supplies the thresholded families:

  Manders M1/M2   per-object thresholds at ``thr_pct`` % of each channel's
                  maximum, sums over the pixels above both
  RWC             the Manders sums weighted by (R - |rank_a - rank_b|) / R,
                  rank_* the dense ranks of the pixel values over the object
                  set's pixels, R = the larger count of distinct values
  Costes C1/C2    image-wide thresholds from CP's linear_costes descent on
                  the 1/costes_scale grid, then per-object masked sums

Dense ranks come from a (256, 256) count table of each channel's 16-bit
codes split into (hi, lo) bytes (K1 with the hi byte as the "label"), turned
into a rank table by exclusive cumsums and picked per pixel (K6). The
Costes descent reads per-pair joint count tables (K1) through suffix sums;
the Pearson statistic of every grid step is evaluated at once on the device
and CP's stepping walks that vector on the host. The masked per-object sums
of all three families are one lane scan per object set (K4 pass E).

With ``costes_fine_scale`` the descent runs at two levels, as the
reference's: the coarse grid brackets the stopping step, and
``costes_fine_refine`` walks the fine grid (1/65535 for uint16 data) inside
that bracket from per-candidate moment sums (K3 over each pixel's entry and
exit candidate).

Every function takes a leading site-batch dimension: image (B, H, W, C),
labels (B, H, W); per-object outputs (B, max_cells).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from saguaro_tpu_torch.kernels import segment_cuda as sc
from saguaro_tpu_torch.kernels.onehot_reduce import onehot_counts, segment_matmul_sums
from saguaro_tpu_torch.kernels.segment_cuda import _pairs

__all__ = [
    "dense_rank_images",
    "costes_thresholds",
    "costes_fine_refine",
    "coloc_threshold_sums",
    "colocalization_features",
    "colocalization_features_multiset",
]

_BIG = 3.4e38
_SCAN_BLOCK = 16


def _exclusive_cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.cumsum(x, dim=dim) - x


def _pick_rows_mc(hi: torch.Tensor, lo: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """Per-pixel two-level table pick: hi, lo (B, N, C) byte codes + tables
    (B, C, 256, 256, K) -> (B, N, C, K), ``tables[b, c, hi, lo, k]``. K6 on
    CUDA."""
    hi = hi.to(torch.int32).contiguous()
    lo = lo.to(torch.int32).contiguous()
    tables = tables.float().contiguous()
    if hi.is_cuda:
        return sc.seg_pick2(hi, lo, tables)
    return sc.pick2_plain(hi, lo, tables)


def _rank_table(cnt2: torch.Tensor):
    """(B, 256, 256) value-count tables -> (dense-rank tables (B, 256, 256),
    distinct values (B,)): rank[v] = number of distinct present values < v."""
    presence = (cnt2 > 0).float()
    lo_excl = _exclusive_cumsum(presence, 2)
    row_tot = presence.sum(dim=2)
    hi_off = _exclusive_cumsum(row_tot, 1)
    return hi_off[:, :, None] + lo_excl, presence.sum(dim=(1, 2))


def _value_count_tables(hi: torch.Tensor, lo: torch.Tensor, insides: list) -> torch.Tensor:
    """Per (channel, mask) (hi, lo) byte-count tables: hi, lo (B, N, C),
    insides M masks (B, N) -> (B, C, 256, 256, M)."""
    out = []
    any_in = functools.reduce(torch.logical_or, insides)
    for c in range(hi.shape[2]):
        cnts = onehot_counts(hi[:, :, c], [(lo[:, :, c], m, 256) for m in insides], 256,
                             label_valid=any_in)
        out.append(torch.stack(cnts, dim=-1))
    return torch.stack(out, dim=1)


def dense_rank_images(codes: torch.Tensor, inside: torch.Tensor):
    """Dense ranks of each pixel's value among the distinct values inside a
    mask, per channel (CP's lexsort/cumsum dense ranking of the RWC block),
    exact for 16-bit integer codes.

    codes (B, N, C) int32 in [0, 65535]; inside (B, N) bool. Returns (ranks
    (B, N, C) f32, 0-based, picked for every pixel from its value's entry
    in the mask's table; distinct values (B, C) f32). The (hi, lo) byte
    counts are one histogram a channel (K1), the rank tables exclusive
    cumsums of their presence, the per-pixel pick one two-level lookup
    (K6)."""
    hi = (codes >> 8).to(torch.int32)
    lo = (codes & 0xFF).to(torch.int32)
    cnts = _value_count_tables(hi, lo, [inside])  # (B, C, 256, 256, 1)
    tables, n_distinct = [], []
    for c in range(codes.shape[2]):
        t, nd = _rank_table(cnts[:, c, :, :, 0])
        tables.append(t)
        n_distinct.append(nd)
    ranks = _pick_rows_mc(hi, lo, torch.stack(tables, dim=1)[..., None])[..., 0]
    return ranks, torch.stack(n_distinct, dim=1)


def _xla_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive f32 cumsum along the last dim in the order of XLA's CPU
    backend, which rewrites the reference's ``jnp.cumsum`` (a reduce-window)
    as a scan of blocks of 16: each block summed in order, the blocks'
    totals scanned the same way (recursively), and each block's running sums
    added to the total of the blocks before it. Every add is one f32
    rounding, so the card and the CPU give the reference's bits."""
    n = x.shape[-1]
    nb = -(-n // _SCAN_BLOCK)
    blocks = torch.nn.functional.pad(x, (0, nb * _SCAN_BLOCK - n)).reshape(
        *x.shape[:-1], nb, _SCAN_BLOCK).clone()
    for j in range(1, _SCAN_BLOCK):
        blocks[..., j] = blocks[..., j - 1] + blocks[..., j]
    if nb > 1:
        tot = _xla_cumsum(blocks[..., -1])
        blocks[..., 1:, :] = blocks[..., 1:, :] + tot[..., :-1, None]
    return blocks.reshape(*x.shape[:-1], nb * _SCAN_BLOCK)[..., :n]


def _suffix2(table: torch.Tensor) -> torch.Tensor:
    """S[..., i, j] = sum_{a >= i, c >= j} table[..., a, c] (f32, the
    reference's ``_suffix2``: reversed cumsums along a, then c, in
    ``_xla_cumsum``'s order), padded with a zero row and column."""
    s = torch.flip(_xla_cumsum(torch.flip(table, (-2,)).transpose(-1, -2)).transpose(-1, -2),
                   (-2,))
    s = torch.flip(_xla_cumsum(torch.flip(s, (-1,))), (-1,))
    return torch.nn.functional.pad(s, (0, 1, 0, 1))


def _fma32_host(a, b, c) -> np.float32:
    """``segment_cuda.fma32`` of host scalars."""
    return np.float32(np.float64(a) * np.float64(b) + np.float64(c))


def _joint_tables(code_s, pairs, insides, s_codes):
    """Per-pair (code_a, code_b) count tables for each mask, fused by leading
    channel: code_s (B, N, C) -> [{(a, b): (B, S, S)} per mask]."""
    by_a: dict[int, list[int]] = {}
    for a, b in pairs:
        by_a.setdefault(a, []).append(b)
    joint = [{} for _ in insides]
    any_in = functools.reduce(torch.logical_or, insides)
    for a, bs in by_a.items():
        outs = onehot_counts(
            code_s[:, :, a], [(code_s[:, :, b], m, s_codes) for b in bs for m in insides], s_codes,
            label_valid=any_in,
        )
        i = 0
        for b in bs:
            for t in joint:
                t[(a, b)] = outs[i]
                i += 1
    return joint


def costes_thresholds(
    values: torch.Tensor,
    inside: torch.Tensor,
    pairs: tuple[tuple[int, int], ...],
    scale: int = 255,
    fast: bool = True,
    joint: dict | None = None,
    return_bracket: bool = False,
):
    """CP 4.2.8 linear_costes for every channel pair and site.

    values (B, N, C) normalized to CP's [0, 1]; inside (B, N) bool ->
    (thr_f (B, P), thr_s (B, P)) in the same units. Thresholds step on the
    1/scale grid as CP's descent does; the region moments of each step come
    from suffix sums of the joint count tables (exact for values on the
    grid, bin floors otherwise). The statistic is evaluated in the
    reference's f32 arithmetic, operation for operation (``_suffix2``'s
    scan order, ``segment_cuda.fma32``'s contractions, correctly rounded
    square roots): its sign stops the descent, and where few pixels lie
    below a step or the channels barely correlate the f32 sums round it
    either way, so only the same roundings stop at the reference's step.
    They are IEEE operations in a fixed order, the same bits on the card
    and the CPU.

    ``return_bracket=True`` also returns ``(regs (B, P, 2), thr_k (B, P),
    prev_k (B, P))``: the regression line, the stopping grid index and the
    grid index visited before it (where the statistic was still positive;
    the pre-skip start when the stop was the first visit), the bracket
    ``costes_fine_refine`` searches."""
    b = values.shape[0]
    dev = values.device
    s_codes = scale + 1
    if joint is None:
        code = torch.clamp((values * scale).to(torch.int32), 0, scale)
        (joint,) = _joint_tables(code, pairs, [inside], s_codes)
    insf = inside.float()
    i_step = 1.0 / scale
    step32 = np.float32(i_step)
    # the grid's values and the region moments in the reference's f32
    val = torch.arange(s_codes, dtype=torch.float32, device=dev) * torch.tensor(step32, device=dev)
    va, vb = val[:, None], val[None, :]

    moments, regs, maxes = [], [], []
    for a, c in pairs:
        cnt2 = joint[(a, c)].float()
        moments.append(torch.stack([
            cnt2, cnt2 * va, cnt2 * vb, cnt2 * va * va, cnt2 * vb * vb, cnt2 * va * vb,
        ], dim=1))  # (B, 6, S, S)
        # the orthogonal regression line over pixels where either channel > 0
        fa, fb = values[..., a], values[..., c]
        nz = insf * ((fa > 0) | (fb > 0)).float()
        m = torch.clamp(nz.sum(dim=1), min=1.0)
        xm = (fa * nz).sum(dim=1) / m
        ym = (fb * nz).sum(dim=1) / m
        dd = torch.clamp(m - 1.0, min=1.0)
        xvar = ((fa - xm[:, None]) ** 2 * nz).sum(dim=1) / dd
        yvar = ((fb - ym[:, None]) ** 2 * nz).sum(dim=1) / dd
        zm = xm + ym
        zvar = ((fa + fb - zm[:, None]) ** 2 * nz).sum(dim=1) / dd
        covar = 0.5 * (zvar - (xvar + yvar))
        num = (yvar - xvar) + torch.sqrt((yvar - xvar) ** 2 + 4.0 * covar**2)
        slope = num / (2.0 * covar)
        regs.append(torch.stack([slope, ym - slope * xm], dim=1))
        maxes.append(torch.stack([
            torch.where(inside, fa, torch.full_like(fa, -_BIG)).amax(dim=1),
            torch.where(inside, fb, torch.full_like(fb, -_BIG)).amax(dim=1),
        ], dim=1))
    suf = _suffix2(torch.stack(moments, dim=1))   # (B, P, 6, S+1, S+1)
    reg = torch.stack(regs, dim=1)    # (B, P, 2)
    mx = torch.stack(maxes, dim=1)    # (B, P, 2)
    n_pairs = len(pairs)

    # Pearson of the pixels outside the [ia:, jb:] rectangle at every grid
    # step k (thr_f = k / scale), all pairs and sites at once
    ks = torch.arange(s_codes + 1, dtype=torch.float32, device=dev)
    thr_f = ks * torch.tensor(step32, device=dev)
    thr_s = sc.fma32(reg[..., :1], thr_f, reg[..., 1:])                # (B, P, K)
    ia = torch.clamp(ks, 0, s_codes).to(torch.int64).expand_as(thr_s)
    # a site without spread (covariance 0) has a NaN regression line; its
    # second threshold reads as code 0, as XLA converts NaN to an integer
    jb = torch.clamp(torch.ceil(thr_s * scale), 0, s_codes).nan_to_num(0.0).to(torch.int64)
    flat = suf.reshape(b, n_pairs, 6, (s_codes + 1) ** 2)
    rect = torch.gather(flat, 3, (ia * (s_codes + 1) + jb)[:, :, None, :].expand(-1, -1, 6, -1))
    n, sf, ss, sff, sss, sfs = (flat[:, :, i, :1] - rect[:, :, i] for i in range(6))
    num = sc.fma32(n, sfs, -(sf * ss))
    var_f = torch.clamp(sc.fma32(n, sff, -(sf * sf)), min=0.0)
    var_s = torch.clamp(sc.fma32(n, sss, -(ss * ss)), min=0.0)
    den = sc.sqrt32(var_f * var_s)
    # scipy.pearsonr of a constant input is nan: it fails every comparison
    cost = torch.where(den > 0, num / den, torch.full_like(num, float("nan")))

    # CP's descent, per site and pair, on the host over the evaluated steps
    cost_h, n_h = cost.cpu().numpy(), n.cpu().numpy()
    reg_h, mx_h = reg.cpu().numpy(), mx.cpu().numpy()
    f32 = np.float32
    thr_k = np.zeros((b, n_pairs), np.float32)
    prev_k = np.zeros((b, n_pairs), np.float32)
    for s in range(b):
        for p in range(n_pairs):
            sa, sb = reg_h[s, p]
            fa_max, fb_max = mx_h[s, p]
            with np.errstate(over="ignore"):  # an empty mask: -inf, the loops never run
                k0 = np.floor(f32(max(fa_max, fb_max)) / step32) + f32(1.0)
            k = k0
            while k * step32 > fa_max and _fma32_host(sa, k * step32, sb) > fb_max:
                k = k - f32(1.0)
            t = prev = k0
            while k > 1.0:
                ki = int(k)
                c, nb = cost_h[s, p, ki], n_h[s, p, ki]
                prev, t = t, k
                # the reference's f32 comparisons (0.45 rounded to f32)
                if not fast or k < 10.0:
                    step = 1.0
                elif c > f32(0.45):
                    step = 10.0
                elif c > f32(0.35):
                    step = 5.0
                elif c > f32(0.25):
                    step = 2.0
                else:
                    step = 1.0
                k = k - f32(step)
                if c <= 0 or nb < 2.0:
                    break
            thr_k[s, p], prev_k[s, p] = t, prev
    thr_f = torch.as_tensor(thr_k, device=dev) * torch.tensor(step32, device=dev)
    thr_s = sc.fma32(reg[..., 0], thr_f, reg[..., 1])
    if return_bracket:
        return thr_f, thr_s, (reg, torch.as_tensor(thr_k, device=dev),
                              torch.as_tensor(prev_k, device=dev))
    return thr_f, thr_s


# bytes of f32 moment lanes the fine descent holds at once: the pairs go to
# K3 in chunks of as many as fit (at 8 sites of 1080² one pair takes 224 MB)
FINE_LANE_BYTES = 1 << 30


def fine_candidates(scale: int, fine: int, fast: bool = True) -> int:
    """Fine grid steps the fine descent walks from the coarse bracket's top:
    one coarse step of the fastest stride (10 with ``fast``, else 1) and
    one more, and two fine steps of margin."""
    return ((10 if fast else 1) + 1) * (fine // scale) + 2


def _skip_start(k0, step, fa_max, fb_max, slope, icept):
    """CP's skip loop in f32: from grid index ``k0`` step down by one while
    both thresholds (k * step and the regression line's value there) lie
    above their channel's maximum; every candidate at once."""
    ks = k0 - np.arange(int(max(k0, 0.0)) + 2, dtype=np.float32)
    i = ks * step
    above = (i > fa_max) & (slope * i + icept > fb_max)
    stop = np.flatnonzero(~above)
    return ks[stop[0]] if stop.size else ks[-1]


def _fine_walk(pear, n_b, k_hi, fast):
    """CP's stepping over the fine candidates t = 0, 1, ... (grid index
    k_hi - t), stopping at the first visited t whose Pearson is <= 0 or
    whose region holds fewer than 2 pixels; returns (the last visited t,
    whether the walk ran off the window's bottom instead: it stepped past
    the last candidate still above the grid's floor without stopping)."""
    m = len(pear)
    t, t_thr = 0.0, 0.0
    while k_hi - t > 1.0:
        if t >= m:
            return t_thr, True
        ti = int(t)
        cost, nb = pear[ti], n_b[ti]
        t_thr = t
        if not fast or k_hi - t < 10.0:
            step = 1.0
        elif cost > 0.45:
            step = 10.0
        elif cost > 0.35:
            step = 5.0
        elif cost > 0.25:
            step = 2.0
        else:
            step = 1.0
        t += step
        if cost <= 0 or nb < 2.0:
            break
    return t_thr, False


def costes_fine_refine(
    values: torch.Tensor,
    inside: torch.Tensor,
    pairs: tuple[tuple[int, int], ...],
    regs: torch.Tensor,
    prev_k: torch.Tensor,
    scale: int = 255,
    fine: int = 65535,
    fast: bool = True,
    return_truncated: bool = False,
):
    """Second-level Costes descent at the data's own resolution (CP runs
    linear_costes at the image's bit depth, 1/65535 for uint16).

    values (B, N, C) normalized to [0, 1], inside (B, N) bool, and the
    coarse pass's ``regs`` (B, P, 2) and ``prev_k`` (B, P)
    (``costes_thresholds(..., return_bracket=True)``) -> (thr_f (B, P),
    thr_s (B, P)) on the 1/fine grid, normalized; with
    ``return_truncated``, also a (B, P) bool array of the walks that ran
    off the window's bottom with the Pearson still positive (their
    threshold is the window's last candidate, not CP's stop; the
    reference makes the same assumption that one coarse step brackets it).

    The walk starts at the coarse bracket's top (or CP's fine skip start,
    if lower) and covers one coarse step of the fastest stride and two fine
    steps more. For descending candidates the above-threshold rectangle
    only grows (the second threshold moves with the first along the
    regression line), so each pixel enters it at one candidate and, for a
    negative slope, leaves it at one. The six moments [1, a, b, a², b², ab]
    of the pixels below the thresholds at every candidate t are then the
    sums over the pixels that enter after t (a suffix sum) plus those that
    left by t (a prefix sum) of per-candidate entry and exit sums: K3
    (``segment_matmul_sums``) with the pixels' candidate indices as labels,
    one site-pair a row of K3's batch; inside pixels that never enter sum
    into the last bin. The values are centred by their inside means first
    (Pearson is shift-invariant). The prefix and suffix sums, the Pearson
    vector and CP's stepping run on the host in f64, over the f32 bin sums:
    the region below is summed directly, where the reference subtracts the
    rectangle from the inside total in f32 and, where few pixels lie below,
    keeps mostly rounding."""
    if fine % scale:
        raise ValueError(f"costes fine scale {fine} is not a multiple of the coarse scale {scale}")
    b, n, n_ch = values.shape
    dev = values.device
    n_pairs = len(pairs)
    f32 = np.float32
    r_ratio = fine // scale
    m_cand = fine_candidates(scale, fine, fast)
    i_f = f32(1.0 / fine)

    # fine integer codes: values on the 1/fine grid round back exactly
    codes_f = torch.clamp(torch.round(values.float() * fine), 0, fine)
    vals_f = codes_f * float(i_f)
    vmax = torch.where(inside[..., None], vals_f, torch.full_like(vals_f, -_BIG)).amax(dim=1)

    reg_h = regs.detach().cpu().numpy().astype(f32)
    prev_h = prev_k.detach().cpu().numpy().astype(f32)
    vmax_h = vmax.cpu().numpy()
    k0 = np.zeros((b, n_pairs), f32)
    k_hi = np.zeros((b, n_pairs), f32)
    for s in range(b):
        for p, (a, c) in enumerate(pairs):
            fa_max, fb_max = vmax_h[s, a], vmax_h[s, c]
            k0[s, p] = np.floor(f32(max(fa_max, fb_max)) / i_f) + f32(1.0)
            k_skip = _skip_start(k0[s, p], i_f, fa_max, fb_max, reg_h[s, p, 0], reg_h[s, p, 1])
            k_hi[s, p] = min(prev_h[s, p] * f32(r_ratio), k_skip)

    # the candidates' second-channel code thresholds (B, P, M)
    slope = torch.as_tensor(reg_h[..., 0], device=dev)
    icept = torch.as_tensor(reg_h[..., 1], device=dev)
    k_hi_d = torch.as_tensor(k_hi, device=dev)
    kf = k_hi_d[..., None] - torch.arange(m_cand, dtype=torch.float32, device=dev)
    jb_t = torch.clamp(torch.ceil(slope[..., None] * kf + (icept * fine)[..., None]), 0, fine + 1)

    top = k_hi_d * float(i_f)
    centre = torch.stack([top, slope * top + icept], dim=-1)       # (B, P, 2)
    chunk = max(1, FINE_LANE_BYTES // max(b * n * 6 * 4, 1))
    enter_sums = torch.zeros((b, n_pairs, m_cand + 1, 6), dtype=torch.float32, device=dev)
    exit_sums = torch.zeros_like(enter_sums)
    outside = ~inside[:, None, :]
    for p0 in range(0, n_pairs, chunk):
        ps = list(range(p0, min(p0 + chunk, n_pairs)))
        a_idx = [pairs[p][0] for p in ps]
        c_idx = [pairs[p][1] for p in ps]
        code_a = codes_f[:, :, a_idx].permute(0, 2, 1)           # (B, Pc, N)
        code_b = codes_f[:, :, c_idx].permute(0, 2, 1).contiguous()
        jb = jb_t[:, ps]
        pos = (slope[:, ps] >= 0)[..., None]
        # entry: the first-channel condition code_a >= kf(t) holds for t >= ca
        enter = torch.clamp(k_hi_d[:, ps, None] - code_a, 0.0, float(m_cand))
        # slope >= 0: jb non-increasing in t, the second holds for t >= cb
        cb_pos = m_cand - torch.searchsorted(jb.flip(-1).contiguous(), code_b, right=True)
        # slope < 0: jb non-decreasing, the second holds for t < exit
        exit_ = torch.searchsorted(jb.contiguous(), code_b, right=True).float()
        del code_a, code_b
        enter = torch.where(pos, torch.maximum(enter, cb_pos.float()), enter)
        exit_ = torch.where(pos, float(m_cand), exit_)
        del cb_pos
        never = exit_ <= enter
        # inside pixels that never enter stay below: the last bin
        enter = torch.where(never, float(m_cand), enter)
        enter = torch.where(outside, -1.0, enter).to(torch.int32)
        exit_ = torch.where(outside | never | (exit_ >= m_cand), -1.0, exit_).to(torch.int32)
        del never
        # centred at the window's top (the thresholds of candidate 0)
        va = vals_f[:, :, a_idx].permute(0, 2, 1) - centre[:, ps, :1]
        vb = vals_f[:, :, c_idx].permute(0, 2, 1) - centre[:, ps, 1:]
        bp = b * len(ps)
        lanes = torch.stack([torch.ones_like(va), va, vb, va * va, vb * vb, va * vb],
                            dim=-1).reshape(bp, n, 6)
        del va, vb
        enter_sums[:, ps] = segment_matmul_sums(enter.reshape(bp, n), lanes, m_cand + 1).reshape(
            b, len(ps), m_cand + 1, 6)
        if bool((~pos).any()):
            exit_sums[:, ps] = segment_matmul_sums(exit_.reshape(bp, n), lanes, m_cand + 1).reshape(
                b, len(ps), m_cand + 1, 6)
        del enter, exit_, lanes

    # moments of the pixels below each candidate, their Pearson, and CP's
    # walk, on the host
    ent = enter_sums.cpu().numpy().astype(np.float64)
    ext = exit_sums.cpu().numpy().astype(np.float64)
    # entered after t: the suffix from t + 1 (the last bin included)
    later = np.cumsum(ent[:, :, ::-1], axis=2)[:, :, ::-1][:, :, 1:]
    below = later + np.cumsum(ext[:, :, :m_cand], axis=2)          # (B, P, M, 6)
    n_b, sf, ss, sff, sss, sfs = np.moveaxis(below, -1, 0)
    num = n_b * sfs - sf * ss
    den = np.sqrt(np.maximum(n_b * sff - sf * sf, 0.0) * np.maximum(n_b * sss - ss * ss, 0.0))
    with np.errstate(divide="ignore", invalid="ignore"):
        pear = np.where(den > 0, num / den, np.nan)
    thr_kf = np.zeros((b, n_pairs), f32)
    truncated = np.zeros((b, n_pairs), bool)
    for s in range(b):
        for p in range(n_pairs):
            if k_hi[s, p] > 1.0:
                t_thr, truncated[s, p] = _fine_walk(pear[s, p].tolist(), n_b[s, p].tolist(),
                                                    float(k_hi[s, p]), fast)
                thr_kf[s, p] = k_hi[s, p] - f32(t_thr)
            else:  # the walk never ran: CP keeps its pre-skip start
                thr_kf[s, p] = k0[s, p]
    thr_f = torch.as_tensor(thr_kf * i_f, device=dev)
    if return_truncated:
        return thr_f, slope * thr_f + icept, truncated
    return thr_f, slope * thr_f + icept


def coloc_threshold_sums(labels, vr, ranks, tff, thr_f, thr_s, inv_r, max_cells):
    """Pass E: every thresholded masked sum in one lane scan. labels (B, N)
    raw ids, vr (B, N, C) raw values, ranks (B, N, C) dense ranks, tff
    (B, max_cells, C) per-object Manders thresholds, thr_f, thr_s (B, P)
    Costes thresholds in raw units, inv_r (B, P) rank normalizers ->
    (B, max_cells, C + 8P) ordered [tot_thr (C) | Manders a, b per pair |
    RWC a, b | Costes a, b, denom_a, denom_b]. K4 pass E on CUDA."""
    consts = torch.stack([thr_f, thr_s, inv_r], dim=1).float().contiguous()
    args = (labels.to(torch.int32).contiguous(), vr.float().contiguous(),
            ranks.float().contiguous(), tff.float().contiguous(), consts, max_cells)
    if labels.is_cuda:
        return sc.seg_lane_sums_e(*args)
    return sc.lane_sums_e_plain(*args)


def _intensity_codes(vr: torch.Tensor, inside_m: torch.Tensor, integer_grid: bool):
    """16-bit intensity codes (B, N, C) + CP's [0, 1] normalizer (B,): raw
    uint16 values are the code; floats quantize on each site's range."""
    b = vr.shape[0]
    if integer_grid:
        codes = torch.clamp(vr.to(torch.int32), 0, 65535)
        return codes, torch.full((b,), 65535.0, dtype=torch.float32, device=vr.device)
    ins = inside_m[..., None]
    vmin_g = torch.where(ins, vr, torch.full_like(vr, _BIG)).amin(dim=1, keepdim=True)
    vmax_g = torch.where(ins, vr, torch.full_like(vr, -_BIG)).amax(dim=1, keepdim=True)
    span = torch.clamp(vmax_g - vmin_g, min=1e-12)
    codes = torch.clamp(((vr - vmin_g) / span * 65535.0).to(torch.int32), 0, 65535)
    norm = torch.clamp(torch.where(ins, vr, torch.zeros_like(vr)).amax(dim=(1, 2)), min=1e-12)
    return codes, norm


def colocalization_features_multiset(
    image: torch.Tensor,
    labels_by_set: dict[str, torch.Tensor],
    vmax_by_set: dict[str, torch.Tensor],
    max_cells: int,
    thr_pct: float = 15.0,
    costes_scale: int = 255,
    costes_fast: bool = True,
    integer_grid: bool = True,
    additive: tuple[str, str, str] | None = ("Cells", "Nuclei", "Cytoplasm"),
    costes_fine_scale: int | None = None,
):
    """Thresholded colocalization of several object sets at once, sharing
    the intensity codes, one rank pick over all sets and channels, and the
    count tables: with ``additive`` = (whole, part1, part2) and whole =
    part1 (+) part2 (Cells = Nuclei + Cytoplasm), only the parts are counted
    and the whole's tables are their sums.

    Returns {set: {(a, b): {"M1", "M2", "RWC1", "RWC2", "C1", "C2"} each
    (B, max_cells), "costes_thr": (thr_f, thr_s) (B, P) normalized}}.
    Empty denominators give 0. With ``costes_fine_scale`` each set's Costes
    thresholds come from the two-level descent (``costes_fine_refine``)."""
    b, h, w, n_ch = image.shape
    names = list(labels_by_set)
    pairs = _pairs(n_ch)
    if not pairs:
        empty = torch.zeros((b, 0), device=image.device)
        return {nm: {"costes_thr": (empty, empty)} for nm in names}
    vr = image.reshape(b, h * w, n_ch).float()
    flats = {nm: labels_by_set[nm].reshape(b, -1).to(torch.int32) for nm in names}
    insides = {nm: flats[nm] > 0 for nm in names}
    any_inside = insides[names[0]]
    for nm in names[1:]:
        any_inside = any_inside | insides[nm]
    codes, norm = _intensity_codes(vr, any_inside, integer_grid)
    hi, lo = codes >> 8, codes & 0xFF
    del codes

    if additive is not None and all(nm in labels_by_set for nm in additive):
        whole, p1, p2 = additive
        count_names, derive = [p1, p2], {whole: (p1, p2)}
    else:
        count_names, derive = names, {}

    cnts = _value_count_tables(hi, lo, [insides[nm] for nm in count_names])
    cnt_by = {nm: cnts[..., i] for i, nm in enumerate(count_names)}
    for whole, (p1, p2) in derive.items():
        cnt_by[whole] = cnt_by[p1] + cnt_by[p2]
    del cnts
    tables, n_distinct = [], {}
    for c in range(n_ch):
        per_set = []
        for nm in names:
            t, nd = _rank_table(cnt_by[nm][:, c])
            per_set.append(t)
            n_distinct.setdefault(nm, []).append(nd)
        tables.append(torch.stack(per_set, dim=-1))
    ranks_all = _pick_rows_mc(hi, lo, torch.stack(tables, dim=1))  # (B, N, C, n_sets)
    del hi, lo, tables

    s_codes = costes_scale + 1
    vn = vr / norm[:, None, None]
    code_s = torch.clamp((vn * costes_scale).to(torch.int32), 0, costes_scale)
    joint_list = _joint_tables(code_s, pairs, [insides[nm] for nm in count_names], s_codes)
    joint_by = dict(zip(count_names, joint_list))
    for whole, (p1, p2) in derive.items():
        joint_by[whole] = {k: joint_by[p1][k] + joint_by[p2][k] for k in joint_by[p1]}
    del code_s

    out = {}
    for k_set, nm in enumerate(names):
        nd = n_distinct[nm]
        inv_r = torch.stack(
            [1.0 / torch.clamp(torch.maximum(nd[a], nd[c]), min=1.0) for a, c in pairs], dim=1
        )
        if costes_fine_scale is not None:
            _, _, (c_regs, _, c_prev) = costes_thresholds(
                vn, insides[nm], pairs, scale=costes_scale, fast=costes_fast,
                joint=joint_by[nm], return_bracket=True,
            )
            thr_f_n, thr_s_n = costes_fine_refine(
                vn, insides[nm], pairs, c_regs, c_prev, scale=costes_scale,
                fine=costes_fine_scale, fast=costes_fast,
            )
        else:
            thr_f_n, thr_s_n = costes_thresholds(
                vn, insides[nm], pairs, scale=costes_scale, fast=costes_fast, joint=joint_by[nm]
            )
        vmax = vmax_by_set[nm]
        tff = (thr_pct / 100.0) * torch.where(
            torch.isfinite(vmax) & (vmax.abs() < 3.38e38), vmax, torch.zeros_like(vmax)
        )
        sums = coloc_threshold_sums(
            flats[nm], vr, ranks_all[..., k_set], tff,
            thr_f_n * norm[:, None], thr_s_n * norm[:, None], inv_r, max_cells,
        )
        p = len(pairs)
        tot_thr = sums[..., :n_ch]
        mand = sums[..., n_ch : n_ch + 2 * p]
        rwcs = sums[..., n_ch + 2 * p : n_ch + 4 * p]
        cots = sums[..., n_ch + 4 * p :]

        def safe(num, den):
            return torch.where(den > 0, num / torch.clamp(den, min=1e-30), torch.zeros_like(num))

        res = {}
        for i, (a, c) in enumerate(pairs):
            res[(a, c)] = {
                "M1": safe(mand[..., 2 * i], tot_thr[..., a]),
                "M2": safe(mand[..., 2 * i + 1], tot_thr[..., c]),
                "RWC1": safe(rwcs[..., 2 * i], tot_thr[..., a]),
                "RWC2": safe(rwcs[..., 2 * i + 1], tot_thr[..., c]),
                "C1": safe(cots[..., 4 * i], cots[..., 4 * i + 2]),
                "C2": safe(cots[..., 4 * i + 1], cots[..., 4 * i + 3]),
            }
        res["costes_thr"] = (thr_f_n, thr_s_n)
        out[nm] = res
    return out


def colocalization_features(
    image: torch.Tensor,
    labels: torch.Tensor,
    vmax: torch.Tensor,
    max_cells: int,
    thr_pct: float = 15.0,
    costes_scale: int = 255,
    costes_fast: bool = True,
    integer_grid: bool = True,
    costes_fine_scale: int | None = None,
):
    """The thresholded colocalization statistics of one object set: image
    (B, H, W, C), labels (B, H, W), vmax (B, max_cells, C) per-object
    channel maxima."""
    return colocalization_features_multiset(
        image, {"obj": labels}, {"obj": vmax}, max_cells,
        thr_pct=thr_pct, costes_scale=costes_scale, costes_fast=costes_fast,
        integer_grid=integer_grid, additive=None, costes_fine_scale=costes_fine_scale,
    )["obj"]
