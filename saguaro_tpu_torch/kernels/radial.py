"""CP-exact radial-distribution geometry, MeasureObjectIntensityDistribution
(port of ``saguaro_tpu/kernels/radial.py``).

CellProfiler bins each object pixel by a normalized distance mixing the
label-aware distance to the object's edge (``shape_extra._label_edt_sq``)
and the distance from the object's centre (its first raster maximum of the
edge distance), propagated by a race of all centres over the union of the
objects with step cost ``sqrt(lam / (1 + lam)) * |step|``:

  normalized = d_from_center / (d_from_center + d_to_edge + 0.001)
  ring       = min(floor(normalized * n_rings), n_rings - 1)

Pixels whose race another object's centre wins are excluded. RadialCV's
octant wedges use the same centre: ``(i > ic) + 2*(j > jc) + 4*(|di| >
|dj|)``. The result is one packed code per pixel, ``ring*8 + wedge``
(``8*n_rings`` = excluded), that the radial lanes of
``fused_measure`` sum.

The race runs as the reference's default form, ``center_race_scan``:
rounds of min-plus associative scans along rows, columns and both
diagonals, whose f32 sums round in ``jax.lax.associative_scan``'s tree
order, so its distances and winners equal the reference's bit for bit.
The 1-step 8-neighbour sweep, ``center_race``, stays beside it, as in the
reference. Every function takes a leading site-batch dimension.
"""

from __future__ import annotations

import numpy as np
import torch

from saguaro_tpu_torch.kernels.morphology import _shift
from saguaro_tpu_torch.kernels.onehot_reduce import mxu_take_t
from saguaro_tpu_torch.kernels.segment_reduce import _flat
from saguaro_tpu_torch.utils import timing

__all__ = ["center_race", "center_race_scan", "cp_ring_wedge"]

_BIG = 3.4e38
_SHIFTS = [
    (-1, 0, 1.0), (1, 0, 1.0), (0, -1, 1.0), (0, 1, 1.0),
    (-1, -1, 2.0 ** 0.5), (-1, 1, 2.0 ** 0.5),
    (1, -1, 2.0 ** 0.5), (1, 1, 2.0 ** 0.5),
]


def _step_scale(lam: float) -> np.float32:
    """``sqrt(lam / (1 + lam))`` as the reference's f32 program rounds it:
    f32 quotient, correctly rounded f32 square root."""
    lam32 = np.float32(lam)
    return np.float32(np.sqrt(np.float64(lam32 / (np.float32(1.0) + lam32))))


def _race_init(labels: torch.Tensor, seeds: torch.Tensor, lam: float):
    """(lab, seeded, dist, won, the eight sweep steps, eps) of a race."""
    dev = labels.device
    lab = labels.to(torch.int32)
    seeded = seeds > 0
    dist = torch.where(
        seeded, torch.zeros(lab.shape, dtype=torch.float32, device=dev),
        torch.full(lab.shape, _BIG, dtype=torch.float32, device=dev),
    )
    scale = torch.tensor(_step_scale(lam), dtype=torch.float32, device=dev)
    steps = [scale * torch.tensor(s, dtype=torch.float32, device=dev) for _, _, s in _SHIFTS]
    eps = torch.tensor(1e-3, dtype=torch.float32, device=dev)
    return lab, seeded, dist, seeds.to(torch.int32), steps, eps


def _sweep(dist, won, lab, grow, steps, eps):
    """One 1-step relaxation over the eight neighbours, in the reference's
    order; a pixel whose own object's centre reaches the best distance
    within ``eps`` keeps its own label."""
    best_d, best_w = dist, won
    for (dy, dx, _), step in zip(_SHIFTS, steps):
        cand = _shift(dist, dy, dx, _BIG) + step
        n_won = _shift(won, dy, dx, 0)
        better = cand < best_d
        tie_own = (cand < best_d + eps) & (n_won == lab) & (best_w != lab)
        take = (better | tie_own) & (n_won > 0)
        best_d = torch.where(take & better, cand, best_d)
        best_w = torch.where(take, n_won, best_w)
    return torch.where(grow, best_d, dist), torch.where(grow, best_w, won)


def _changed(dist, won, d0, w0) -> torch.Tensor:
    # own-label tie flips move won without improving dist: watch both
    return (dist < d0).any() | (won != w0).any()


def center_race(
    labels: torch.Tensor, seeds: torch.Tensor, lam: float = 1.0, check_every: int = 16
) -> tuple[torch.Tensor, torch.Tensor]:
    """centrosome ``propagate(zeros, seeds, labels != 0, lam)``.

    labels, seeds: (B, H, W) int32 (seeds: the centre pixels carrying their
    object's label, 0 elsewhere). Races every seed over ``labels > 0``
    with step cost ``sqrt(lam/(1+lam)) * |step|`` and returns ``(dist,
    won)``: the accumulated cost and the winning seed label per pixel
    (unreached pixels keep dist=3.4e38, won=0). Sweeps run in blocks of
    ``check_every`` until a block changes no distance and no winner.

    Tie rule: a pixel whose own object's centre reaches the optimal
    distance within 1e-3 keeps its own label; the eight shifts are visited
    in the reference's order, which decides the remaining ties."""
    lab, seeded, dist, won, steps, eps = _race_init(labels, seeds, lam)
    grow = (lab > 0) & ~seeded
    cap = lab.shape[-2] * lab.shape[-1]
    it = 0
    while it < cap:
        d0, w0 = dist, won
        for _ in range(check_every):
            dist, won = _sweep(dist, won, lab, grow, steps, eps)
        it += check_every
        timing.count("rounds/center_race", check_every)
        if not timing.flag(_changed(dist, won, d0, w0), "center_race"):
            break
    return dist, won


# --- min-plus scan race -----------------------------------------------------
#
# Along one line of a direction family (rows, columns, either diagonal) the
# relaxation d[j] = min_k (d[k] + |j - k| * step), blocked at pixels outside
# the objects, is a scan of the affine-min maps f(x) = min(c, x + k): a pixel
# is the triple (c, k, w) of its distance, its step (3.4e38 when blocked) and
# its winner, and two maps compose to (min(c2, c1 + k2), min(k1 + k2, 3.4e38))
# with the winner of the side that gives c. A round relaxes both directions
# of the four families; any 8-neighbour path is a few straight runs, so a
# race takes a few rounds where the sweep takes about one sweep a pixel of
# radius. Diagonals are read as columns of the wrapped shear.


def _minplus_combine(a, b):
    """The reference's composition of two min-plus maps ``(c, k, w)``."""
    c1, k1, w1 = a
    c2, k2, w2 = b
    through = c1 + k2
    c = torch.minimum(c2, through)
    w = torch.where(c2 <= through, w2, w1)
    k = torch.clamp(k1 + k2, max=_BIG)
    return c, k, w


def _scan_into(c, k, w, out_c, out_w, out_k=None):
    """Inclusive scan of ``_minplus_combine`` along the last dim, in
    ``jax.lax.associative_scan``'s tree order (jax 0.9.0), written into the
    views ``out_c``, ``out_w`` (and ``out_k``): combine the pairs (2i, 2i+1)
    and scan those recursively into the odd outputs; each even output 2i
    is combine(odd output i-1, element 2i); the first is the first
    element. Every f32 add of the reference happens here, on the same
    operands. An output's k feeds only later outputs' k, so without
    ``out_k`` none is formed."""
    n = c.shape[-1]
    if n < 2:
        out_c.copy_(c)
        out_w.copy_(w)
        if out_k is not None:
            out_k.copy_(k)
        return
    rc, rk, rw = _minplus_combine((c[..., 0 : n - 1 : 2], k[..., 0 : n - 1 : 2], w[..., 0 : n - 1 : 2]),
                                  (c[..., 1::2], k[..., 1::2], w[..., 1::2]))
    _scan_into(rc, rk, rw, out_c[..., 1::2], out_w[..., 1::2],
               None if out_k is None else out_k[..., 1::2])
    m = (n - 1) // 2  # even outputs after the first
    c1, w1 = out_c[..., 1::2][..., :m], out_w[..., 1::2][..., :m]
    c2, k2, w2 = c[..., 2::2], k[..., 2::2], w[..., 2::2]
    through = c1 + k2
    torch.minimum(c2, through, out=out_c[..., 2::2])
    torch.where(c2 <= through, w2, w1, out=out_w[..., 2::2])
    out_c[..., :1] = c[..., :1]
    out_w[..., :1] = w[..., :1]
    if out_k is not None:
        torch.clamp(out_k[..., 1::2][..., :m] + k2, max=_BIG, out=out_k[..., 2::2])
        out_k[..., :1] = k[..., :1]


def minplus_scan(c, k, w, dim: int, reverse: bool = False, with_k: bool = False):
    """``jax.lax.associative_scan(_minplus_combine, (c, k, w), axis=dim,
    reverse=reverse)`` of the reference, bit for bit: (c, k) f32, w int32,
    all of one shape. ``reverse`` flips, scans and flips back. Returns
    (c, w), or (c, k, w) with ``with_k``."""
    elems = [t.movedim(dim, -1) for t in (c, k, w)]
    if reverse:
        elems = [t.flip(-1) for t in elems]
    outs = [torch.empty_like(t) for t in (elems if with_k else (elems[0], elems[2]))]
    if with_k:
        _scan_into(*elems, outs[0], outs[2], outs[1])
    else:
        _scan_into(*elems, *outs)
    if reverse:
        outs = [t.flip(-1) for t in outs]
    return tuple(t.movedim(-1, dim) for t in outs)


def _shear(a: torch.Tensor, fill) -> torch.Tensor:
    """Wrapped shear of each site: (B, H, W) -> (B, R, W), R = ceil(H (W+1)
    / W). One ``fill`` column is padded and the flat site re-read at width
    W, so row r comes out shifted right by r modulo W + 1 and column j holds
    the anti-diagonals r + c = j (mod W + 1), whose pieces the padded cell
    between them separates (filled as blocked, it stops a run)."""
    b, h, w = a.shape
    flat = torch.nn.functional.pad(a, (0, 1), value=fill).reshape(b, -1)
    n = h * (w + 1)
    rows = -(-n // w)
    flat = torch.nn.functional.pad(flat, (0, rows * w - n), value=fill)
    return flat.reshape(b, rows, w)


def _unshear(s: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Inverse of ``_shear``: drop the tail, re-read each site at W + 1."""
    b = s.shape[0]
    return s.reshape(b, -1)[:, : h * (w + 1)].reshape(b, h, w + 1)[..., :w]


def _relax_family(dist, won, lab, blocked, step, dim, eps):
    """Both scan directions of one direction family (lines along ``dim``),
    each merged by strict improvement with the own-label tie override of
    the sweep."""
    big = torch.full((), _BIG, dtype=torch.float32, device=dist.device)
    k = torch.where(blocked, big, step)
    c = torch.where(blocked, big, dist)
    for rev in (False, True):
        oc, ow = minplus_scan(c, k, won, dim, reverse=rev)
        live = ow > 0
        better = (oc < dist) & live
        tie_own = (oc < dist + eps) & live & (ow == lab) & (won != lab)
        dist = torch.where(better, oc, dist)
        won = torch.where(better | tie_own, ow, won)
        c = torch.where(blocked, big, dist)
    return dist, won


def center_race_scan(
    labels: torch.Tensor, seeds: torch.Tensor, lam: float = 1.0
) -> tuple[torch.Tensor, torch.Tensor]:
    """``center_race``'s contract by min-plus scans, the reference's default
    race: rounds of 8 run-length relaxations (rows, columns, the (1, -1)
    diagonals by the shear, the (1, 1) ones by a flip and the shear, each
    both ways) until a round changes no distance and no winner, then
    1-step sweeps until one changes nothing (they settle the own-label ties
    that the scans break label-blind). Each loop reads one flag back to the
    host a round or sweep, counted under ``rounds/`` and ``waits/`` of
    ``center_race_scan`` and ``center_race_scan.settle`` (``utils.timing``);
    a batch runs until every site has converged, and a converged site's
    further rounds leave it as it is, so every site equals the reference's,
    bit for bit."""
    lab, seeded, dist, won, steps, eps = _race_init(labels, seeds, lam)
    _, h, w = lab.shape
    a_step, d_step = steps[0], steps[4]
    inside = lab > 0
    blocked = ~inside
    lab_sh = _shear(lab, 0)
    blk_sh = _shear(blocked, True)
    lab_fsh = _shear(lab.flip(-1), 0)
    blk_fsh = _shear(blocked.flip(-1), True)

    while True:
        d0, w0 = dist, won
        dist, won = _relax_family(dist, won, lab, blocked, a_step, 2, eps)
        dist, won = _relax_family(dist, won, lab, blocked, a_step, 1, eps)
        ds, ws = _relax_family(_shear(dist, _BIG), _shear(won, 0), lab_sh, blk_sh, d_step, 1, eps)
        dist, won = _unshear(ds, h, w), _unshear(ws, h, w)
        ds, ws = _relax_family(_shear(dist.flip(-1), _BIG), _shear(won.flip(-1), 0),
                               lab_fsh, blk_fsh, d_step, 1, eps)
        dist, won = _unshear(ds, h, w).flip(-1), _unshear(ws, h, w).flip(-1)
        timing.count("rounds/center_race_scan")
        if not timing.flag(_changed(dist, won, d0, w0), "center_race_scan"):
            break

    grow = inside & ~seeded
    while True:
        d0, w0 = dist, won
        dist, won = _sweep(dist, won, lab, grow, steps, eps)
        timing.count("rounds/center_race_scan.settle")
        if not timing.flag(_changed(dist, won, d0, w0), "center_race_scan.settle"):
            break
    return dist, won


def cp_ring_wedge(
    labels: torch.Tensor,
    max_cells: int,
    n_rings: int,
    max_radius: int = 64,
    lam: float = 1.0,
    d2_img: torch.Tensor | None = None,
    max_d2: torch.Tensor | None = None,
) -> torch.Tensor:
    """(B, H, W) labels -> (B, H, W) int32 packed CP ring/wedge code,
    ``ring*8 + wedge``, ``8*n_rings`` for excluded pixels (outside any
    object, or captured by another object's centre in the race).

    ``d2_img``: the shared ``shape_extra._label_edt_sq`` image; ``max_d2``:
    (B, max_cells) per-object maximum of it (MaximumRadius**2 from
    ``radius_features``), else a segment max."""
    from saguaro_tpu_torch.kernels.shape_extra import _label_edt_sq

    lab = labels.to(torch.int32)
    b, h, w = lab.shape
    dev = lab.device
    if d2_img is None:
        d2_img = _label_edt_sq(lab, max_radius)
    d_edge = torch.sqrt(d2_img)
    flat = lab.reshape(b, -1)
    seg = _flat(lab, max_cells)
    inside_m = flat > 0
    d2f = d2_img.reshape(b, -1)
    n = flat.shape[1]
    idx = seg.long()

    if max_d2 is None:
        max_d2 = torch.full((b, max_cells), -float("inf"), dtype=torch.float32, device=dev)
        max_d2.scatter_reduce_(1, idx, torch.where(inside_m, d2f, torch.full_like(d2f, -1.0)),
                               "amax", include_self=False)
    # centre = first raster maximum of the edge distance; the integer d2
    # values are >= 1 apart, so the half-step tolerance is exact
    lin = torch.arange(n, dtype=torch.float32, device=dev).expand(b, n)
    g_m = mxu_take_t(max_d2, seg, max_cells)[:, 0]
    is_max = inside_m & (d2f >= g_m - 0.5)
    first = torch.full((b, max_cells), float("inf"), dtype=torch.float32, device=dev)
    first.scatter_reduce_(1, idx, torch.where(is_max, lin, torch.full_like(lin, float(n))),
                          "amin", include_self=False)
    cy = torch.floor(first / w)
    cx = first - cy * w
    g = mxu_take_t(torch.stack([first, cy, cx], dim=2), seg, max_cells)  # (B, 3, N)
    center_mask = inside_m & ((lin - g[:, 0]).abs() < 0.5)
    seeds = torch.where(center_mask, flat, torch.zeros_like(flat)).reshape(b, h, w)

    dist, won = center_race_scan(lab, seeds, lam=lam)
    good = (won == lab) & (lab > 0) & (dist < _BIG / 2.0)
    norm = dist / (dist + d_edge + 0.001)
    ring = torch.clamp((norm * n_rings).to(torch.int32), 0, n_rings - 1)

    yy = torch.arange(h, dtype=torch.float32, device=dev).repeat_interleave(w)
    xx = torch.arange(w, dtype=torch.float32, device=dev).repeat(h)
    dy = yy - g[:, 1]
    dx = xx - g[:, 2]
    wedge = (
        (dy > 0).to(torch.int32)
        + 2 * (dx > 0).to(torch.int32)
        + 4 * (dy.abs() > dx.abs()).to(torch.int32)
    )
    rw = torch.where(good.reshape(b, -1), ring.reshape(b, -1) * 8 + wedge,
                     torch.full_like(wedge, 8 * n_rings))
    return rw.reshape(b, h, w)
