"""The reference's segmentation, written from cellpose's definitions and
independent of the program, of ``reference/plain`` and of the rest of the
benchmark: cellpose's input normalisation, the rescale and the tiling of
the network's input, and cellpose's mask recovery in NumPy (``get_masks``,
``remove_bad_flow_masks``, the hole filling of
``fill_holes_and_remove_small_masks``). The network itself is an argument,
its forward pass over tiles (``networks/<name>.forward``).

Where the engine states a rule of its own, the reference follows the rule,
not the engine's code: masks at the network's resolution with the minimum
size scaled by area; the flows followed by 2**ceil(log2(flow_iters))
rounded whole-pixel steps (its batched integration) instead of cellpose's
bilinear Euler steps; the flow-error QC against unit vectors towards each
mask's centroid instead of cellpose's heat-diffusion flows; the rescale by
``diam_mean / diameter`` as an antialiased bilinear resize with half-pixel
centres, and the labels back at the input size by nearest neighbour with
half-pixel centres; a field larger than one tile covered by cellpose's
tile grid and the tiles' outputs averaged under the engine's taper window
(a ramp over 0.1 tile + 1 pixels from each edge); a field of one tile run
as it is."""

from __future__ import annotations

import math

import numpy as np
import scipy.ndimage as ndi
import torch

# ------------------------------------------------------------ network input


def normalize(img: np.ndarray) -> np.ndarray:
    """cellpose ``normalize_img``: each channel of (H, W, C) to its 1st and
    99th percentiles (``np.percentile``), zero where they meet."""
    x = img.astype(np.float64)
    out = np.zeros_like(x)
    for c in range(x.shape[-1]):
        lo, hi = np.percentile(x[..., c], [1.0, 99.0])
        if hi - lo > 1e-3:
            out[..., c] = (x[..., c] - lo) / (hi - lo)
    return out


def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of a bilinear resize with half-pixel centres,
    its triangle widened by the factor when shrinking, each row summing to
    one."""
    scale = n_out / n_in
    width = max(1.0 / scale, 1.0)
    centre = (np.arange(n_out) + 0.5) / scale - 0.5
    wts = np.maximum(0.0, 1.0 - np.abs(centre[:, None] - np.arange(n_in)[None, :]) / width)
    return wts / wts.sum(axis=1, keepdims=True)


def network_size(h0: int, w0: int, diam_mean: float, diameter: float, tile: int) -> tuple[int, int]:
    s = diam_mean / diameter
    return max(tile // 4, int(round(h0 * s))), max(tile // 4, int(round(w0 * s)))


def network_input(sites: np.ndarray, net: dict, diameter: float) -> tuple[np.ndarray, int, int]:
    """(B, H, W, C) raw sites -> (B, n_channels, max(h, tile), max(w,
    tile)) f32: the first ``n_channels`` channels normalised, rescaled to
    (h, w), zero-padded to at least one tile; and (h, w)."""
    b, h0, w0, _ = sites.shape
    tile = net["tile"]
    h1, w1 = network_size(h0, w0, net["diam_mean"], diameter, tile)
    wy, wx = resize_weights(h0, h1), resize_weights(w0, w1)
    x = np.zeros((b, net["n_channels"], max(h1, tile), max(w1, tile)), np.float32)
    for i, site in enumerate(sites):
        z = normalize(site[..., : net["n_channels"]])
        x[i, :, :h1, :w1] = np.einsum("yh,hwc,xw->cyx", wy, z, wx, optimize=True)
    return x, h1, w1


def tile_starts(size: int, tile: int, overlap: float) -> list[int]:
    """Tile offsets covering [0, size): cellpose's grid, a stride of
    int(tile x (1 - overlap)) and a last tile flush with the end."""
    if size <= tile:
        return [0]
    stride = max(1, int(tile * (1 - overlap)))
    starts = list(range(0, size - tile + 1, stride))
    if starts[-1] != size - tile:
        starts.append(size - tile)
    return starts


def taper(tile: int) -> np.ndarray:
    """The engine's window over a tile: on each axis a ramp from 1 / (0.1
    tile + 1) at the edge up to 1, 0.1 tile + 1 pixels in; their product."""
    k = np.arange(tile)
    ramp = np.minimum(np.minimum(k + 1, tile - k) / (0.1 * tile + 1), 1.0)
    return ramp[:, None] * ramp[None, :]


def network_output(x: np.ndarray, forward, net: dict, device) -> np.ndarray:
    """(B, C, hp, wp) network input -> (B, 3, hp, wp) f32 output. A field of
    one tile goes through ``forward`` as it is; a larger one tile by tile
    of cellpose's grid (the batch's tiles at one place a call), the tiles'
    outputs averaged under ``taper`` in float64."""
    tile = net["tile"]
    ys = tile_starts(x.shape[2], tile, net["tile_overlap"])
    xs = tile_starts(x.shape[3], tile, net["tile_overlap"])
    with torch.no_grad():
        if len(ys) == len(xs) == 1:
            return forward(torch.as_tensor(x, device=device)).float().cpu().numpy()
        win = taper(tile)
        acc = np.zeros((x.shape[0], 3) + x.shape[2:])
        wsum = np.zeros(x.shape[2:])
        for y in ys:
            for x0 in xs:
                part = torch.as_tensor(np.ascontiguousarray(x[:, :, y : y + tile, x0 : x0 + tile]), device=device)
                acc[:, :, y : y + tile, x0 : x0 + tile] += forward(part).float().cpu().numpy() * win
                wsum[y : y + tile, x0 : x0 + tile] += win
    return (acc / wsum).astype(np.float32)


def flows_at_network_resolution(sites: np.ndarray, forward, net: dict, diameter: float,
                                device) -> tuple[np.ndarray, np.ndarray]:
    """(B, H, W, C) raw sites -> flows (B, 2, h, w) and cellprob (B, h, w)
    at the rescaled size; ``forward`` is the segmenter's forward pass over
    tiles and ``net`` its section of the configuration (``n_channels``,
    ``diam_mean``, ``tile``, ``tile_overlap``)."""
    x, h1, w1 = network_input(sites, net, diameter)
    out = network_output(x, forward, net, device)[:, :, :h1, :w1]
    return out[:, :2], out[:, 2]


# ------------------------------------------------------------------ dynamics


def follow_flows(dp: np.ndarray, active: np.ndarray, steps: int) -> tuple[np.ndarray, np.ndarray]:
    """Each active pixel takes ``steps`` steps, each the flow at the pixel
    it stands on, rounded half to even and held inside the image (the
    engine's batched integration of cellpose's flows); an inactive pixel
    has no flow and stays where it is."""
    h, w = active.shape
    ys, xs = np.nonzero(active)
    fy, fx = np.where(active, dp[0], 0.0), np.where(active, dp[1], 0.0)
    gy, gx = np.mgrid[0:h, 0:w]
    ny = np.clip(np.rint(gy + fy), 0, h - 1).astype(np.int64)
    nx = np.clip(np.rint(gx + fx), 0, w - 1).astype(np.int64)
    y, x = ys.copy(), xs.copy()
    for _ in range(steps):
        y, x = ny[y, x], nx[y, x]
    return np.stack([ys, xs]), np.stack([y, x])


def get_masks(start: np.ndarray, end: np.ndarray, shape: tuple[int, int]) -> np.ndarray:
    """cellpose ``get_masks``: the end points' histogram; seeds at its 5x5
    local maxima over 10; seeds grown 5 times over their 3x3 neighbours
    where the histogram exceeds 2 (the larger seed number wins a tie); each
    pixel labelled by its end point. Seeds are numbered in raster order."""
    hist = np.zeros(shape)
    np.add.at(hist, (end[0], end[1]), 1.0)
    seeds = (hist >= ndi.maximum_filter(hist, 5, mode="constant")) & (hist > 10)
    lab = np.zeros(shape, np.int64)
    lab[seeds] = np.arange(1, int(seeds.sum()) + 1)
    for _ in range(5):
        grown = ndi.maximum_filter(lab, 3, mode="constant")
        lab = np.where((lab == 0) & (hist > 2), grown, lab)
    out = np.zeros(shape, np.int64)
    out[start[0], start[1]] = lab[end[0], end[1]]
    return out


def relabel(lab: np.ndarray, min_size: int = 0) -> np.ndarray:
    """Masks under ``min_size`` pixels dropped, the rest numbered 1..n in
    the order of their old numbers."""
    ids, counts = np.unique(lab[lab > 0], return_counts=True)
    keep = ids[counts >= min_size]
    lut = np.zeros(int(lab.max()) + 1, np.int32)
    lut[keep] = np.arange(1, keep.size + 1)
    return lut[lab]


def drop_bad_flow_masks(lab: np.ndarray, dp: np.ndarray, threshold: float, max_cells: int) -> np.ndarray:
    """cellpose ``remove_bad_flow_masks`` against the centroid field: masks
    whose mean squared gap between the network's flows / 5 and the unit
    vectors towards their centroid exceeds ``threshold`` are removed (masks
    numbered ``max_cells`` or more are not judged)."""
    n = int(lab.max())
    if n == 0:
        return lab
    idx = np.arange(1, n + 1)
    gy, gx = np.mgrid[0 : lab.shape[0], 0 : lab.shape[1]].astype(np.float64)
    cy, cx = ndi.mean(gy, lab, idx), ndi.mean(gx, lab, idx)
    inside = lab > 0
    k = lab[inside] - 1
    dy, dx = cy[k] - gy[inside], cx[k] - gx[inside]
    norm = np.hypot(dy, dx) + 1e-6
    err = (dp[0][inside] / 5.0 - dy / norm) ** 2 + (dp[1][inside] / 5.0 - dx / norm) ** 2
    mean = np.bincount(k, err, n) / np.bincount(k, None, n)
    bad = idx[(mean > threshold) & (idx < max_cells)]
    if bad.size == 0:
        return lab
    lut = np.arange(n + 1)
    lut[bad] = 0
    return relabel(lut[lab])


def fill_holes(lab: np.ndarray) -> np.ndarray:
    """Background enclosed by masks takes the label most common on its
    one-pixel ring (8 neighbours)."""
    holes = ndi.binary_fill_holes(lab > 0) & (lab == 0)
    if not holes.any():
        return lab
    out = lab.copy()
    parts, n = ndi.label(holes)
    for k in range(1, n + 1):
        m = parts == k
        ring = out[ndi.binary_dilation(m, np.ones((3, 3), bool)) & ~m]
        ring = ring[ring > 0]
        if ring.size:
            out[m] = np.bincount(ring).argmax()
    return out


def nearest_up(lab: np.ndarray, h0: int, w0: int) -> np.ndarray:
    h1, w1 = lab.shape
    iy = np.floor((np.arange(h0) + 0.5) * h1 / h0).astype(np.int64)
    ix = np.floor((np.arange(w0) + 0.5) * w1 / w0).astype(np.int64)
    return lab[iy][:, ix]


def segment(sites: np.ndarray, forward, net: dict, engine: dict, device) -> np.ndarray:
    """(B, H, W, C) raw sites -> (B, H, W) int32 labels, through the
    segmenter's ``forward`` over tiles (its section of the configuration:
    ``net``) and the engine's settings."""
    b, h0, w0, _ = sites.shape
    dp, prob = flows_at_network_resolution(sites, forward, net, engine["diameter"], device)
    h1, w1 = prob.shape[1:]
    min_size = engine["min_size"]
    min_low = max(1, int(round(min_size * h1 * w1 / (h0 * w0)))) if min_size else 0
    steps = 2 ** max(1, math.ceil(math.log2(max(engine["flow_iters"], 2))))
    out = np.zeros((b, h0, w0), np.int32)
    for i in range(b):
        active = prob[i] > engine["cellprob_threshold"]
        start, end = follow_flows(dp[i] / 5.0, active, steps)
        lab = relabel(get_masks(start, end, (h1, w1)), min_low)
        if engine["flow_error_threshold"] is not None:
            lab = drop_bad_flow_masks(lab, dp[i], engine["flow_error_threshold"], engine["max_cells"])
        if engine["fill_holes"]:
            lab = fill_holes(lab)
        out[i] = nearest_up(lab, h0, w0)
    return out
