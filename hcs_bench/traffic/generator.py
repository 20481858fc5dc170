"""The one generator of the benchmark's traffic: site batches of uint16
fields, made on the host from a seed and a traffic file's parameters, as
decoded TIFFs would arrive.

Each nucleus is a cone of intensity in every channel (``peak`` at its
centre, 0 at its radius) over a uniform background: an intensity whose
gradient points to the centre with one magnitude everywhere inside, which
the ``gradient_cpnet`` weights turn into cellpose flows. Frozen copy of
``chip_smoke.cone_sites``: a jittered square grid (its step, start and
margin from the traffic file), a radius drawn for each nucleus. Every seed
gives the same number of nuclei a site; only their places and radii
move.
"""

from __future__ import annotations

import numpy as np


def seed_sequence(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator for one stream of a run's seed (any whole number;
    negative and large seeds map onto 63 bits)."""
    return np.random.default_rng([seed % (1 << 63), stream])


def _centres(params: dict, rng: np.random.Generator) -> list[tuple[int, int, float]]:
    """Nuclei on a jittered square grid, a radius drawn for each."""
    size, (lo, hi) = params["size"], params["radius"]
    step, start = params["grid_step"], params["grid_start"]
    margin, jit = params["grid_margin"], params["jitter"]
    out = []
    for cy in range(start, size - margin, step):
        for cx in range(start, size - margin, step):
            y, x = cy + rng.integers(-jit, jit + 1), cx + rng.integers(-jit, jit + 1)
            out.append((int(y), int(x), float(rng.uniform(lo, hi))))
    return out


def make_site(params: dict, rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """One site: ((size, size, channels) uint16 field, (n, 3) nuclei as
    (cy, cx, radius))."""
    size, n_ch = params["size"], params["channels"]
    lo, hi = params["background"]
    img = rng.integers(lo, hi, (size, size, n_ch), dtype=np.uint16)
    centres = _centres(params, rng)
    half = int(np.ceil(params["radius"][1])) + 1
    yy, xx = np.mgrid[-half : half + 1, -half : half + 1]
    dist = np.hypot(yy, xx)
    for y, x, r in centres:
        # background + floor(cone): the uint16 cast of their float sum
        cone = np.floor(params["peak"] * np.maximum(0.0, 1.0 - dist / r)).astype(np.uint16)
        y0, y1, x0, x1 = y - half, y + half + 1, x - half, x + half + 1
        cy0, cx0 = max(0, -y0), max(0, -x0)
        cy1, cx1 = cone.shape[0] - max(0, y1 - size), cone.shape[1] - max(0, x1 - size)
        img[max(0, y0) : min(size, y1), max(0, x0) : min(size, x1)] += cone[cy0:cy1, cx0:cx1, None]
    return img, np.array(centres, np.float64)


def make_batches(params: dict, seed: int) -> tuple[list[np.ndarray], list[list[np.ndarray]]]:
    """``distinct_batches`` batches of ``sites_per_batch`` sites, each a
    (B, size, size, channels) uint16 array on the host, and each site's
    nuclei as ``make_site`` gives them."""
    rng = seed_sequence(seed, 0)
    batches, nuclei = [], []
    for _ in range(params["distinct_batches"]):
        sites = [make_site(params, rng) for _ in range(params["sites_per_batch"])]
        batches.append(np.stack([img for img, _ in sites]))
        nuclei.append([c for _, c in sites])
    return batches, nuclei


def nuclei_labels(params: dict, centres: np.ndarray) -> np.ndarray:
    """(size, size) int32 discs of the placed nuclei, labelled 1..n in
    placement order (the weights' calibration crops)."""
    size = params["size"]
    half = int(np.ceil(params["radius"][1])) + 1
    out = np.zeros((size, size), np.int32)
    for k, (y, x, r) in enumerate(centres, start=1):
        y, x = int(y), int(x)
        y0, x0 = max(0, y - half), max(0, x - half)
        yy, xx = np.mgrid[y0 : min(size, y + half + 1), x0 : min(size, x + half + 1)]
        win = out[y0 : y0 + yy.shape[0], x0 : x0 + yy.shape[1]]
        win[(yy - y) ** 2 + (xx - x) ** 2 <= r * r] = k
    return out
