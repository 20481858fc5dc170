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

The race is the 1-step 8-neighbour sweep (``center_race``); the reference
also has a min-plus scan form of it and holds the two equal in distances
and winners. Every function takes a leading site-batch dimension.
"""

from __future__ import annotations

import torch

from saguaro_tpu_torch.kernels.morphology import _shift
from saguaro_tpu_torch.kernels.onehot_reduce import mxu_take_t
from saguaro_tpu_torch.kernels.segment_reduce import _flat

__all__ = ["center_race", "cp_ring_wedge"]

_BIG = 3.4e38
_SHIFTS = [
    (-1, 0, 1.0), (1, 0, 1.0), (0, -1, 1.0), (0, 1, 1.0),
    (-1, -1, 2.0 ** 0.5), (-1, 1, 2.0 ** 0.5),
    (1, -1, 2.0 ** 0.5), (1, 1, 2.0 ** 0.5),
]


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
    dev = labels.device
    lab = labels.to(torch.int32)
    inside = lab > 0
    scale = torch.tensor((lam / (1.0 + lam)) ** 0.5, dtype=torch.float32, device=dev)
    eps = 1e-3
    seeded = seeds > 0
    dist = torch.where(
        seeded, torch.zeros(lab.shape, dtype=torch.float32, device=dev),
        torch.full(lab.shape, _BIG, dtype=torch.float32, device=dev),
    )
    won = seeds.to(torch.int32)
    steps = [scale * torch.tensor(s, dtype=torch.float32, device=dev) for _, _, s in _SHIFTS]
    grow = inside & ~seeded

    def sweep(dist, won):
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

    cap = lab.shape[-2] * lab.shape[-1]
    it = 0
    while it < cap:
        d0, w0 = dist, won
        for _ in range(check_every):
            dist, won = sweep(dist, won)
        it += check_every
        # own-label tie flips move won without improving dist: watch both
        if not bool((dist < d0).any() | (won != w0).any()):
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

    dist, won = center_race(lab, seeds, lam=lam)
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
