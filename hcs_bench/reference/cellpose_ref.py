"""The reference's segmentation, written from cellpose's definitions and
independent of the program and of ``reference/plain``: CPnet's forward
pass (cellpose ``resnet_torch.CPnet``) as plain functions over the state
dict, cellpose's input normalisation, and cellpose's mask recovery in
NumPy (``get_masks``, ``remove_bad_flow_masks``, the hole filling of
``fill_holes_and_remove_small_masks``).

Where the engine states a rule of its own, the reference follows the rule,
not the engine's code: masks at the network's resolution with the minimum
size scaled by area; the flows followed by 2**ceil(log2(flow_iters))
rounded whole-pixel steps (its batched integration) instead of cellpose's
bilinear Euler steps; the flow-error QC against unit vectors towards each
mask's centroid instead of cellpose's heat-diffusion flows; the rescale by
``diam_mean / diameter`` as an antialiased bilinear resize with half-pixel
centres, and the labels back at the input size by nearest neighbour with
half-pixel centres. A site that needs more than one tile is refused: the
configurations run one."""

from __future__ import annotations

import math

import numpy as np
import scipy.ndimage as ndi
import torch
import torch.nn.functional as F

# ------------------------------------------------------------------ network


def cpnet_state(cp: dict, device) -> dict:
    """A CPnet state dict in cellpose's key layout at the configuration's
    widths: every convolution and Linear zero, every BatchNorm the
    identity."""
    nbase = [cp["n_channels"], *cp["features"]]
    nbaseup = nbase[1:] + [nbase[-1]]
    sd: dict = {}

    def bn(p, c):
        sd.update({f"{p}.weight": torch.ones(c), f"{p}.bias": torch.zeros(c),
                   f"{p}.running_mean": torch.zeros(c), f"{p}.running_var": torch.ones(c),
                   f"{p}.num_batches_tracked": torch.zeros((), dtype=torch.long)})

    def conv(p, cin, cout, k, relu=True):
        bn(f"{p}.0", cin)
        q = f"{p}.2" if relu else f"{p}.1"
        sd.update({f"{q}.weight": torch.zeros(cout, cin, k, k), f"{q}.bias": torch.zeros(cout)})

    for n in range(len(nbase) - 1):
        p = f"downsample.down.res_down_{n}"
        conv(f"{p}.proj", nbase[n], nbase[n + 1], 1, relu=False)
        for t in range(4):
            conv(f"{p}.conv.conv_{t}", nbase[n] if t == 0 else nbase[n + 1], nbase[n + 1], 3)
    for n in range(1, len(nbaseup)):
        p, cin, cout = f"upsample.up.res_up_{n - 1}", nbaseup[n], nbaseup[n - 1]
        conv(f"{p}.conv.conv_0", cin, cout, 3)
        for t in range(1, 4):
            conv(f"{p}.conv.conv_{t}.conv", cout, cout, 3)
            sd.update({f"{p}.conv.conv_{t}.full.weight": torch.zeros(cout, nbaseup[-1]),
                       f"{p}.conv.conv_{t}.full.bias": torch.zeros(cout)})
        conv(f"{p}.proj", cin, cout, 1, relu=False)
    conv("output", nbaseup[0], 3, 1)
    return {k: v.to(device) for k, v in sd.items()}


def _bn(x, sd, p):
    return F.batch_norm(x, sd[f"{p}.running_mean"].float(), sd[f"{p}.running_var"].float(),
                        sd[f"{p}.weight"].float(), sd[f"{p}.bias"].float(), False, 0.0, 1e-5)


def _conv(x, sd, p, dtype):
    w = sd[f"{p}.weight"]
    return F.conv2d(x.to(dtype), w.to(dtype), sd[f"{p}.bias"].to(dtype), padding=w.shape[-1] // 2)


def _batchconv(x, sd, p, dtype):
    """BatchNorm, ReLU, convolution (cellpose ``batchconv``)."""
    return _conv(F.relu(_bn(x.float(), sd, f"{p}.0")), sd, f"{p}.2", dtype)


def _batchconv0(x, sd, p, dtype):
    """BatchNorm, convolution (cellpose ``batchconv0``)."""
    return _conv(_bn(x.float(), sd, f"{p}.0"), sd, f"{p}.1", dtype)


def _resdown(x, sd, p, dtype):
    x = _batchconv0(x, sd, f"{p}.proj", dtype) + _batchconv(
        _batchconv(x, sd, f"{p}.conv.conv_0", dtype), sd, f"{p}.conv.conv_1", dtype)
    return x + _batchconv(_batchconv(x, sd, f"{p}.conv.conv_2", dtype), sd, f"{p}.conv.conv_3", dtype)


def _convstyle(style, x, sd, p, dtype, y=None):
    if y is not None:
        x = x + y
    feat = F.linear(style, sd[f"{p}.full.weight"].float(), sd[f"{p}.full.bias"].float())
    return _batchconv(x + feat[:, :, None, None].to(x.dtype), sd, f"{p}.conv", dtype)


def _resup(x, y, style, sd, p, dtype):
    x = _batchconv0(x, sd, f"{p}.proj", dtype) + _convstyle(
        style, _batchconv(x, sd, f"{p}.conv.conv_0", dtype), sd, f"{p}.conv.conv_1", dtype, y=y)
    return x + _convstyle(style, _convstyle(style, x, sd, f"{p}.conv.conv_2", dtype), sd,
                          f"{p}.conv.conv_3", dtype)


def cpnet_features(x: torch.Tensor, sd: dict, depth: int, dtype=torch.float32) -> torch.Tensor:
    """CPnet up to its head: (N, C, H, W) -> (N, nbase[1], H, W).
    Convolutions in ``dtype``, BatchNorm and the style in float32."""
    xd = []
    for n in range(depth):
        y = x.to(dtype) if n == 0 else F.max_pool2d(xd[-1], 2)
        xd.append(_resdown(y, sd, f"downsample.down.res_down_{n}", dtype))
    style = xd[-1].float().mean(dim=(2, 3))
    style = style / torch.sqrt((style**2).sum(dim=1, keepdim=True))
    x = _resup(xd[-1], xd[-1], style, sd, f"upsample.up.res_up_{depth - 1}", dtype)
    for n in range(depth - 2, -1, -1):
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        x = _resup(x, xd[n], style, sd, f"upsample.up.res_up_{n}", dtype)
    return x


def cpnet(x: torch.Tensor, sd: dict, depth: int, dtype=torch.float32) -> torch.Tensor:
    """CPnet (cellpose ``resnet_torch.CPnet``) on (N, C, H, W) -> (N, 3, H,
    W): [flow_y, flow_x, cellprob logit]; the head in float32."""
    return _batchconv(cpnet_features(x, sd, depth, dtype).float(), sd, "output", torch.float32)


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


def network_input(sites: np.ndarray, cp: dict, diameter: float) -> tuple[np.ndarray, int, int]:
    """(B, H, W, C) raw sites -> (B, n_channels, tile, tile) f32: the first
    ``n_channels`` channels normalised, rescaled to (h, w), zero-padded to
    the tile; and (h, w)."""
    b, h0, w0, _ = sites.shape
    tile = cp["tile"]
    h1, w1 = network_size(h0, w0, cp["diam_mean"], diameter, tile)
    if h1 > tile or w1 > tile:
        raise ValueError(f"{h1}x{w1} at the network's scale needs more than one {tile} tile")
    wy, wx = resize_weights(h0, h1), resize_weights(w0, w1)
    x = np.zeros((b, cp["n_channels"], tile, tile), np.float32)
    for i, site in enumerate(sites):
        z = normalize(site[..., : cp["n_channels"]])
        x[i, :, :h1, :w1] = np.einsum("yh,hwc,xw->cyx", wy, z, wx, optimize=True)
    return x, h1, w1


def flows_at_network_resolution(sites: np.ndarray, sd: dict, cp: dict, diameter: float, device,
                                dtype=torch.float32) -> tuple[np.ndarray, np.ndarray]:
    """(B, H, W, C) raw sites -> flows (B, 2, h, w) and cellprob (B, h, w)
    at the rescaled size."""
    x, h1, w1 = network_input(sites, cp, diameter)
    with torch.no_grad():
        out = cpnet(torch.as_tensor(x, device=device), sd, len(cp["features"]), dtype)
    out = out.float().cpu().numpy()[:, :, :h1, :w1]
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


def segment(sites: np.ndarray, sd: dict, cp: dict, engine: dict, device,
            dtype=torch.float32) -> np.ndarray:
    """(B, H, W, C) raw sites -> (B, H, W) int32 labels."""
    b, h0, w0, _ = sites.shape
    dp, prob = flows_at_network_resolution(sites, sd, cp, engine["diameter"], device, dtype)
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
