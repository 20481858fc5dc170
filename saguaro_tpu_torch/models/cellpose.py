"""Cellpose CPnet segmentation network and its tiled, diameter-rescaled
inference (port of ``saguaro_tpu/models/cellpose.py``).

``CellposeUNet`` is cellpose's CPnet: pre-activation BN -> ReLU -> Conv
blocks, residual down/up stages over ``[n_channels, *features]``, a style
vector (L2-normalised global average of the bottleneck) added through
per-stage Linear layers in the decoder, and a 1x1 BN -> ReLU -> Conv head to
3 channels (flow_y, flow_x, cellprob logit). Its state-dict keys are
cellpose's own (``downsample.down.res_down_0.proj.0.weight`` ...), so a
cellpose checkpoint loads with ``load_state_dict``; ``models/weights``
bridges the JAX package's flax variables onto the same keys.

The public layout is the JAX one, channels last: the network maps
(B, H, W, C_in) to (B, H, W, 3). BatchNorm runs in inference mode in f32;
convolutions run in ``config.compute_dtype`` (bf16 by default) and the head
in f32, as in the flax module. The convolutions are cuDNN's: the JAX
package left them to XLA, with no Pallas kernel.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from saguaro_tpu_torch.device import resolve_device

__all__ = [
    "CellposeConfig",
    "CellposeUNet",
    "init_cellpose",
    "convert_input",
    "normalize_input",
    "segment_image",
    "segment_image_batch",
    "segment_tiles",
    "flow_loss",
    "train_step",
]


@dataclass(frozen=True)
class CellposeConfig:
    n_channels: int = 2            # cellpose convention: [primary, nuclear/zero]
    features: tuple[int, ...] = (32, 64, 128, 256)
    diam_mean: float = 30.0        # training diameter (px)
    tile: int = 224                # inference tile size
    tile_overlap: float = 0.1
    cellprob_threshold: float = 0.0
    flow_iters: int = 200          # steps of mask recovery
    compute_dtype: str = "bfloat16"


def _dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}[name]


class _BatchConv(nn.Sequential):
    """cellpose ``batchconv`` (BN, ReLU, Conv: keys .0/.2) or, with
    ``relu=False``, ``batchconv0`` (BN, Conv: keys .0/.1). BN in f32, the
    convolution in ``dtype``."""

    def __init__(self, cin: int, cout: int, k: int, relu: bool = True, dtype=torch.bfloat16):
        layers = [nn.BatchNorm2d(cin, eps=1e-5)]
        if relu:
            layers.append(nn.ReLU())
        layers.append(nn.Conv2d(cin, cout, k, padding=k // 2))
        super().__init__(*layers)
        self.compute_dtype = dtype

    def forward(self, x):
        x = self[0](x.float())
        if len(self) == 3:
            x = F.relu(x)
        conv = self[-1]
        return F.conv2d(
            x.to(self.compute_dtype), conv.weight.to(self.compute_dtype), conv.bias.to(self.compute_dtype),
            padding=conv.padding,
        )


class _ResDown(nn.Module):
    """cellpose ``resdown``: x = proj(x) + c1(c0(x)); x = x + c3(c2(x))."""

    def __init__(self, cin, cout, dtype):
        super().__init__()
        self.conv = nn.Sequential()
        self.proj = _BatchConv(cin, cout, 1, relu=False, dtype=dtype)
        for t in range(4):
            self.conv.add_module(f"conv_{t}", _BatchConv(cin if t == 0 else cout, cout, 3, dtype=dtype))

    def forward(self, x):
        x = self.proj(x) + self.conv[1](self.conv[0](x))
        return x + self.conv[3](self.conv[2](x))


class _StyleConv(nn.Module):
    """cellpose ``batchconvstyle``: conv(x [+ y] + Linear(style))."""

    def __init__(self, cin, cout, style_ch, dtype):
        super().__init__()
        self.conv = _BatchConv(cin, cout, 3, dtype=dtype)
        self.full = nn.Linear(style_ch, cout)

    def forward(self, style, x, y=None):
        if y is not None:
            x = x + y
        feat = self.full(style.float())
        return self.conv(x + feat[:, :, None, None].to(x.dtype))


class _ResUp(nn.Module):
    """cellpose ``resup``: x = proj(x) + c1(style, c0(x), y=skip);
    x = x + c3(style, c2(style, x))."""

    def __init__(self, cin, cout, style_ch, dtype):
        super().__init__()
        self.conv = nn.Sequential()
        self.conv.add_module("conv_0", _BatchConv(cin, cout, 3, dtype=dtype))
        for t in range(1, 4):
            self.conv.add_module(f"conv_{t}", _StyleConv(cout, cout, style_ch, dtype))
        self.proj = _BatchConv(cin, cout, 1, relu=False, dtype=dtype)

    def forward(self, x, y, style):
        x = self.proj(x) + self.conv[1](style, self.conv[0](x), y=y)
        return x + self.conv[3](style, self.conv[2](style, x))


class _Downsample(nn.Module):
    def __init__(self, nbase, dtype):
        super().__init__()
        self.down = nn.Sequential()
        for n in range(len(nbase) - 1):
            self.down.add_module(f"res_down_{n}", _ResDown(nbase[n], nbase[n + 1], dtype))

    def forward(self, x):
        xd = []
        for n in range(len(self.down)):
            y = F.max_pool2d(xd[n - 1], 2, stride=2) if n > 0 else x
            xd.append(self.down[n](y))
        return xd


class _Upsample(nn.Module):
    def __init__(self, nbaseup, dtype):
        super().__init__()
        self.up = nn.Sequential()
        for n in range(1, len(nbaseup)):
            self.up.add_module(
                f"res_up_{n - 1}", _ResUp(nbaseup[n], nbaseup[n - 1], nbaseup[-1], dtype)
            )

    def forward(self, style, xd):
        x = self.up[-1](xd[-1], xd[-1], style)
        for n in range(len(self.up) - 2, -1, -1):
            x = F.interpolate(x, scale_factor=2, mode="nearest")
            x = self.up[n](x, xd[n], style)
        return x


class CellposeUNet(nn.Module):
    """(B, H, W, C_in) -> (B, H, W, 3): [flow_y, flow_x, cellprob logit]."""

    def __init__(self, config: CellposeConfig = CellposeConfig()):
        super().__init__()
        self.config = config
        dtype = _dtype(config.compute_dtype)
        nbase = [config.n_channels, *config.features]
        self.downsample = _Downsample(nbase, dtype)
        nbaseup = nbase[1:] + [nbase[-1]]
        self.upsample = _Upsample(nbaseup, dtype)
        self.output = _BatchConv(nbaseup[0], 3, 1, dtype=torch.float32)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2).to(_dtype(self.config.compute_dtype))
        xd = self.downsample(x)
        style = xd[-1].float().mean(dim=(2, 3))
        style = style / torch.sqrt(torch.clamp((style**2).sum(dim=1, keepdim=True), min=1e-12))
        out = self.output(self.upsample(style, xd).float())
        return out.permute(0, 2, 3, 1)


def init_cellpose(
    config: CellposeConfig = CellposeConfig(),
    seed: int = 0,
    device: str | torch.device | None = None,
) -> CellposeUNet:
    """A CellposeUNet in eval mode on ``device`` (CUDA unless the caller
    names one) with random weights drawn from a seeded generator on the
    CPU: convolution and Linear weights normal with variance 1/fan_in, zero
    biases, BatchNorm at identity statistics."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    model = CellposeUNet(config)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen) / math.sqrt(fan_in))
                m.bias.zero_()
    return model.eval().to(device)


# ----------------------------------------------------------------------------
# Tiled inference


def _taper(tile: int) -> np.ndarray:
    """Smooth window weighting tile interiors over their borders."""
    ramp = np.minimum(np.arange(tile) + 1, tile - np.arange(tile))
    ramp = np.minimum(ramp / (0.1 * tile + 1), 1.0)
    return (ramp[:, None] * ramp[None, :]).astype(np.float32)


def convert_input(images: torch.Tensor, nchan: int = 2) -> torch.Tensor:
    """cellpose's default channel selection (``convert_image`` with
    channels=None): the first ``nchan`` raw channels, zero-padded when
    fewer. (..., H, W, C) -> (..., H, W, nchan) f32."""
    c = images.shape[-1]
    x = images[..., :nchan].float()
    if c < nchan:
        x = F.pad(x, (0, nchan - c))
    return x


def _percentile(x: torch.Tensor, q: float, dim: int) -> torch.Tensor:
    """np.percentile's linear interpolation along ``dim`` (kept dim)."""
    s = torch.sort(x, dim=dim).values
    n = s.shape[dim]
    pos = q / 100.0 * (n - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    a = s.narrow(dim, lo, 1)
    b = s.narrow(dim, hi, 1)
    return a + (b - a) * frac


def normalize_input(x: torch.Tensor) -> torch.Tensor:
    """cellpose ``normalize_img`` per image and channel of a (B, H, W, C)
    batch: (x - p1) / (p99 - p1), zeroed where p99 - p1 <= 1e-3."""
    b, h, w, c = x.shape
    flat = x.reshape(b, h * w, c)
    lo = _percentile(flat, 1.0, 1)[:, None]  # (B, 1, 1, C)
    hi = _percentile(flat, 99.0, 1)[:, None]
    out = (x - lo) / torch.clamp(hi - lo, min=1e-6)
    return torch.where(hi - lo > 1e-3, out, torch.zeros_like(out))


def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of ``jax.image.resize(..., 'bilinear')`` along
    one axis (jax.image.scale's compute_weight_mat, evaluated in f32 as it
    is there): the triangle kernel, widened by the scale when downsampling
    (antialiasing), each output row normalised."""
    f32 = np.float32
    inv = 1.0 / (n_out / n_in)
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * f32(inv) - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / f32(max(inv, 1.0))
    wts = np.maximum(f32(0.0), f32(1.0) - x)
    tot = wts.sum(axis=0, keepdims=True, dtype=f32)
    wts = np.where(np.abs(tot) > f32(1000.0 * np.finfo(np.float32).eps),
                   wts / np.where(tot != 0, tot, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], wts, f32(0.0)).T.astype(f32)


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """(B, H, W, C) -> (B, h, w, C) as ``jax.image.resize(..., 'bilinear')``
    (antialiased when downsampling): one weight matrix per axis."""
    h, w = x.shape[1:3]
    wy = torch.from_numpy(_resize_weights(h, out_hw[0])).to(x.device)
    wx = torch.from_numpy(_resize_weights(w, out_hw[1])).to(x.device)
    return torch.einsum("yh,bhwc,xw->byxc", wy, x.float(), wx)


def resize_nearest(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """(B, H, W) -> (B, h, w) as ``jax.image.resize(..., 'nearest')``:
    source index floor((i + 0.5) * in / out), computed in f32."""
    h, w = x.shape[1:3]

    def idx(n_in, n_out):
        pos = (torch.arange(n_out, dtype=torch.float32) + 0.5) * n_in / n_out
        return torch.floor(pos).to(torch.int64).to(x.device)

    return x[:, idx(h, out_hw[0])][:, :, idx(w, out_hw[1])]


def _tile_grid(size: int, tile: int, overlap: float) -> tuple[int, ...]:
    """Start offsets covering [0, size) with ~overlap fraction of overlap."""
    if size <= tile:
        return (0,)
    stride = max(1, int(tile * (1 - overlap)))
    starts = list(range(0, size - tile + 1, stride))
    if starts[-1] != size - tile:
        starts.append(size - tile)
    return tuple(starts)


@torch.no_grad()
def segment_tiles(model: CellposeUNet, tiles: torch.Tensor) -> torch.Tensor:
    """The network over an (N, tile, tile, C) batch of tiles on the model's
    device -> (N, tile, tile, 3) f32 [flow_y, flow_x, cellprob logit] (the
    reference's ``segment_tiles(apply_fn, variables, tiles)``, the module
    in place of its function and variables)."""
    device = next(model.parameters()).device
    return model(torch.as_tensor(tiles, device=device).float()).float()


def _network_shape(h0: int, w0: int, config: CellposeConfig, diameter: float | None):
    scale = 1.0 if not diameter else config.diam_mean / float(diameter)
    h1 = max(config.tile // 4, int(round(h0 * scale)))
    w1 = max(config.tile // 4, int(round(w0 * scale)))
    return h1, w1


@torch.no_grad()
def _segment_full_batch(model, images, net_hw, tile, ys, xs, out_hw, n_seg=None):
    """(B, H, W, C) -> flows (B, 2, h, w), cellprob (B, h, w): normalise at
    the original resolution, rescale, tile, run the network on the tiles of
    the whole batch at once, merge with a taper window, optionally rescale
    back. With ``n_seg`` the raw batch is converted first (first n_seg
    channels)."""
    b = images.shape[0]
    h1, w1 = net_hw
    if n_seg is not None:
        images = convert_input(images, nchan=n_seg)
    c = images.shape[-1]
    x = normalize_input(images.float())
    x = resize_bilinear(x, (h1, w1))
    hp, wp = max(h1, tile), max(w1, tile)
    x = F.pad(x, (0, 0, 0, wp - w1, 0, hp - h1))
    tiles = torch.stack([x[:, y : y + tile, xx : xx + tile] for y in ys for xx in xs])
    n = tiles.shape[0]
    out = model(tiles.reshape(n * b, tile, tile, c)).float().reshape(n, b, tile, tile, 3)
    win = torch.from_numpy(_taper(tile)).to(x.device)[None, :, :, None]
    acc = torch.zeros((b, hp, wp, 3), dtype=torch.float32, device=x.device)
    wacc = torch.zeros((b, hp, wp, 1), dtype=torch.float32, device=x.device)
    k = 0
    for y in ys:
        for xx in xs:
            acc[:, y : y + tile, xx : xx + tile] += out[k] * win
            wacc[:, y : y + tile, xx : xx + tile] += win
            k += 1
    merged = (acc / torch.clamp(wacc, min=1e-6))[:, :h1, :w1]
    if out_hw is not None and tuple(out_hw) != (h1, w1):
        merged = resize_bilinear(merged, out_hw)
    flows = merged[..., :2].permute(0, 3, 1, 2)
    return flows, merged[..., 2]


def segment_image_batch(
    model: CellposeUNet,
    images: torch.Tensor,
    config: CellposeConfig = CellposeConfig(),
    diameter: float | None = None,
    at_network_resolution: bool = False,
    n_seg: int | None = None,
):
    """Full-image network pass with diameter rescale + overlap-tiled eval
    over a (B, H, W, C) batch on the model's device. Returns (flows
    (B, 2, h, w), cellprob (B, h, w)) at the original resolution, or at
    the rescaled network resolution with ``at_network_resolution``.
    ``n_seg``: build the network input from the first n_seg raw channels.
    """
    b, h0, w0 = images.shape[:3]
    h1, w1 = _network_shape(h0, w0, config, diameter)
    t = config.tile
    ys = _tile_grid(max(h1, t), t, config.tile_overlap)
    xs = _tile_grid(max(w1, t), t, config.tile_overlap)
    out_hw = None if at_network_resolution else (h0, w0)
    return _segment_full_batch(model, images, (h1, w1), t, ys, xs, out_hw, n_seg)


def segment_image(
    model: CellposeUNet,
    image: torch.Tensor,
    config: CellposeConfig = CellposeConfig(),
    diameter: float | None = None,
    at_network_resolution: bool = False,
):
    """Single-image full pass over an (H, W, C) image on the model's
    device: per-image normalisation, the bilinear rescale to the network
    resolution, tiling and the taper merge, as the batched pass on a batch
    of one. Returns (flows (2, h, w), cellprob (h, w), None), at the
    original resolution or, with ``at_network_resolution``, at the rescaled
    one (the reference's (flows, cellprob, styles) with no styles)."""
    flows, cellprob = segment_image_batch(
        model, image[None], config, diameter=diameter, at_network_resolution=at_network_resolution
    )
    return flows[0], cellprob[0], None


# ----------------------------------------------------------------------------
# Training (flow regression)


def flow_loss(pred: torch.Tensor, target_flows: torch.Tensor, target_prob: torch.Tensor) -> torch.Tensor:
    """Cellpose's objective on NHWC tensors: the MSE of the flows against 5x
    the (B, H, W, 2) targets plus a numerically stable BCE of the cellprob
    logit against the (B, H, W) targets."""
    mse = torch.mean((pred[..., :2] - 5.0 * target_flows) ** 2)
    logits = pred[..., 2]
    bce = torch.mean(
        torch.clamp(logits, min=0) - logits * target_prob + torch.log1p(torch.exp(-torch.abs(logits)))
    )
    return mse + bce


def train_step(model: CellposeUNet, optimizer: torch.optim.Optimizer, batch) -> torch.Tensor:
    """One optimiser step on ``batch`` = (images (B, H, W, C), target flows
    (B, H, W, 2), target cellprob (B, H, W)); returns the step's loss,
    detached. The model stays in eval mode: its BatchNorms normalise by
    their stored statistics, which training leaves as they are (the
    reference feeds fixed ``batch_stats``); gradients reach the f32 weights
    through the casts to the compute dtype."""
    images, target_flows, target_prob = batch
    optimizer.zero_grad(set_to_none=True)
    loss = flow_loss(model(images), target_flows, target_prob)
    loss.backward()
    optimizer.step()
    return loss.detach()
