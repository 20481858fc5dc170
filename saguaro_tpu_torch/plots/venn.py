"""Two-set area-proportional Venn diagram, matplotlib_venn-free (a copy of
``saguaro_tpu/plots/venn.py``; matplotlib is imported where a diagram is
drawn, so the layout solver needs none).

The reference uses matplotlib_venn.venn2 for the bioactivity overview
(Inuction_Score_hit.py:141,170-173). matplotlib_venn renders circles
whose AREAS are proportional to the set sizes and whose center distance
is solved so the lens area matches the intersection — so a subset
relationship (every timepoint-active well is bioactive) renders as
CONTAINMENT and equal sets render concentric. This module reproduces
that geometry with plain matplotlib: circle radii r = sqrt(|S|/pi) and
the center distance bisected from the circular-lens area equation.
"""

from __future__ import annotations

import math

__all__ = ["venn2", "solve_venn2_layout"]


def _lens_area(r1: float, r2: float, d: float) -> float:
    """Area of intersection of circles (r1, r2) at center distance d."""
    if d >= r1 + r2:
        return 0.0
    if d <= abs(r1 - r2):
        r = min(r1, r2)
        return math.pi * r * r
    a1 = math.acos((d * d + r1 * r1 - r2 * r2) / (2 * d * r1))
    a2 = math.acos((d * d + r2 * r2 - r1 * r1) / (2 * d * r2))
    tri = 0.5 * math.sqrt(
        max(
            (-d + r1 + r2) * (d + r1 - r2) * (d - r1 + r2) * (d + r1 + r2),
            0.0,
        )
    )
    return r1 * r1 * a1 + r2 * r2 * a2 - tri


def solve_venn2_layout(n_a: int, n_b: int, n_ab: int):
    """(r_a, r_b, d): area-proportional radii and the center distance
    whose lens area equals the intersection count.

    Cases matplotlib_venn distinguishes: equal sets -> concentric (d=0);
    subset -> contained (d <= |r_a - r_b|); disjoint -> separated with a
    small gap; partial overlap -> bisection on the lens-area equation.
    """
    r_a = math.sqrt(max(n_a, 0) / math.pi)
    r_b = math.sqrt(max(n_b, 0) / math.pi)
    if n_a == 0 and n_b == 0:
        return 1.0, 1.0, 3.0
    r_a = max(r_a, 1e-3)
    r_b = max(r_b, 1e-3)
    if n_ab == 0:
        return r_a, r_b, (r_a + r_b) * 1.2
    if n_ab >= min(n_a, n_b):  # subset (or equal)
        if n_a == n_b:
            return r_a, r_b, 0.0
        # nest the smaller circle, offset toward the rim for readable
        # labels but fully contained
        return r_a, r_b, abs(r_a - r_b) * 0.6
    lo, hi = abs(r_a - r_b), r_a + r_b
    target = float(n_ab)
    for _ in range(64):
        mid = 0.5 * (lo + hi)
        if _lens_area(r_a, r_b, mid) > target:
            lo = mid
        else:
            hi = mid
    return r_a, r_b, 0.5 * (lo + hi)


def venn2(sets, set_labels=("A", "B"), ax=None):
    import matplotlib.pyplot as plt
    from matplotlib.patches import Circle

    a, b = (set(s) for s in sets)
    n_a, n_b, n_ab = len(a), len(b), len(a & b)
    only_a, only_b = n_a - n_ab, n_b - n_ab
    r_a, r_b, d = solve_venn2_layout(n_a, n_b, n_ab)
    ax = ax or plt.gca()

    xa, xb = -d / 2.0, d / 2.0
    ax.add_patch(Circle((xa, 0), r_a, alpha=0.4, color="#4C72B0"))
    ax.add_patch(Circle((xb, 0), r_b, alpha=0.4, color="#DD8452"))

    contained = d <= abs(r_a - r_b) + 1e-12
    if contained:
        # inner circle holds the intersection count; the outer ring the
        # remainder of the bigger set
        inner_x, outer_x = (xa, xb) if r_a < r_b else (xb, xa)
        r_in, r_out = min(r_a, r_b), max(r_a, r_b)
        if n_ab:
            ax.text(inner_x, 0, str(n_ab), ha="center", va="center")
        rest = only_b if r_a < r_b else only_a
        if rest:
            # ring midpoint on the far side of the inner circle
            edge_in = inner_x + r_in if inner_x >= outer_x else inner_x - r_in
            edge_out = outer_x + r_out if inner_x >= outer_x else outer_x - r_out
            ax.text((edge_in + edge_out) / 2.0, 0, str(rest),
                    ha="center", va="center")
    else:
        if only_a:
            ax.text((xa - r_a + min(xb - r_b, xa + r_a)) / 2.0, 0,
                    str(only_a), ha="center", va="center")
        if only_b:
            ax.text((xb + r_b + max(xa + r_a, xb - r_b)) / 2.0, 0,
                    str(only_b), ha="center", va="center")
        if n_ab:
            ax.text((xb - r_b + xa + r_a) / 2.0, 0, str(n_ab),
                    ha="center", va="center")
    ax.text(xa, -r_a - 0.25, str(set_labels[0]), ha="center", va="top")
    ax.text(xb, r_b + 0.25, str(set_labels[1]), ha="center", va="bottom")
    lim = max(r_a + abs(xa), r_b + abs(xb)) + 0.5
    ax.set_xlim(-lim, lim)
    ax.set_ylim(-lim, lim)
    ax.set_aspect("equal")
    ax.axis("off")
    return ax
