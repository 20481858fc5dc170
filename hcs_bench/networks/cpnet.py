"""CPnet, cellpose's U-Net (``resnet_torch.CPnet``), as a segmenter of the
benchmark: its weights from the seed, its FLOPs a site, and its forward
pass as plain functions over the state dict, written from cellpose's
definitions and independent of the program.

The configuration's ``cellpose`` section holds its sizes (``n_channels``,
``features``, ``diam_mean``, ``tile``, ``tile_overlap``) and the dotted
path of the program's config class; ``weights`` holds the draw's
parameters (``gradient_cpnet``)."""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from hcs_bench.reference.cellpose_ref import network_input
from hcs_bench.reference.plain.device import full_f32
from hcs_bench.reference.precision import fp8_convolutions
from hcs_bench.weights import draw_normal
from hcs_bench.yardstick import tile_starts

SECTION = "cellpose"

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


def forward(cfg: dict, state: dict, device, lower: bool = False):
    """The reference's CPnet on (N, n_channels, tile, tile) tiles: float32,
    or, with ``lower``, the control's precision (convolutions in bfloat16
    on inputs and weights rounded to fp8 e4m3)."""
    depth = len(cfg[SECTION]["features"])
    dtype = torch.bfloat16 if lower else torch.float32

    def run(x: torch.Tensor) -> torch.Tensor:
        with fp8_convolutions() if lower else contextlib.nullcontext():
            return cpnet(x, state, depth, dtype)

    return run


# ------------------------------------------------------------------ weights

# The rows kept at zero so that the designed path stays exact: channel 0
# of res_down_0's output is the first input channel, channel 0 of
# res_up_0's conv_1 input is that again, and channels 0-4 of res_up_0's
# output are the designed differences alone.
_QUIET_ROWS = (
    ("downsample.down.res_down_0.conv.conv_1.2.weight", 1),
    ("downsample.down.res_down_0.conv.conv_3.2.weight", 1),
    ("upsample.up.res_up_0.conv.conv_0.2.weight", 1),
    ("upsample.up.res_up_0.conv.conv_1.full.weight", 1),
    ("upsample.up.res_up_0.proj.1.weight", 5),
    ("upsample.up.res_up_0.conv.conv_3.conv.2.weight", 5),
)


@torch.no_grad()
def gradient_cpnet(cp: dict, device, gain: float, cellprob_at: float, seed: int, noise: float,
                   sites: np.ndarray, diameter: float, cellprob_noise: float) -> dict:
    """After ``chip_smoke.gradient_cpnet``, made on ``device``: a CPnet
    state dict at the configuration's widths (``cp``) in which a designed
    path turns cone-shaped nuclei into flows towards each centre, and every
    other layer adds to the cell probability.

    Every convolution and Linear gets weights normal with variance
    ``noise``**2 / fan_in, drawn in one call of a generator on ``device``
    seeded with ``seed`` (biases zero, BatchNorm the identity). Then the
    designed path is set by hand: the first block's projection copies the
    first input channel; res_up_0's first style conv takes its central
    differences (+-d/dy, +-d/dx, and the value); the head turns them into
    flows (``gain`` times the gradient) and a cell probability 10 x (value
    - ``cellprob_at``); the rows that would feed that path (``_QUIET_ROWS``)
    are zero. The head's cell probability also reads res_up_0's other
    channels, which carry the deeper blocks, the style and the skips,
    through random weights scaled on ``sites`` (one batch, through the
    float32 reference) so that their share has mean 0 and standard
    deviation ``cellprob_noise`` over its pixels: every layer moves the
    masks' edges, while the flows stay the designed ones."""
    sd = cpnet_state(cp, device)
    drawn = [sd[k] for k, v in sd.items() if k.endswith(".weight") and v.dim() >= 2]
    draw_normal(drawn, seed, device, lambda x, t: x * (noise / math.sqrt(t[0].numel())))
    for key, rows in _QUIET_ROWS:
        sd[key][:rows] = 0.0
    proj = sd["downsample.down.res_down_0.proj.1.weight"]
    proj[0] = 0.0
    proj[0, 0] = 1.0
    w = sd["upsample.up.res_up_0.conv.conv_1.conv.2.weight"]
    w[:5] = 0.0
    w[0, 0, 1, 1] = 1.0
    for ch, sign, (a, b) in ((1, 1, (2, 1)), (2, -1, (2, 1)), (3, 1, (1, 2)), (4, -1, (1, 2))):
        w[ch, 0, a, b] = 0.5 * sign
        w[ch, 0, 2 - a, 2 - b] = -0.5 * sign
    head, head_b = sd["output.2.weight"][:, :, 0, 0], sd["output.2.bias"]
    other = head[2, 5:].clone()
    head.zero_()
    head[0, 1], head[0, 2] = gain, -gain
    head[1, 3], head[1, 4] = gain, -gain
    head[2, 0] = 10.0
    x, h1, w1 = network_input(sites, cp, diameter)
    with full_f32():
        # the head's BatchNorm is the identity: its input, after the ReLU
        feat = torch.relu(cpnet_features(torch.as_tensor(x, device=device), sd, len(cp["features"])))
        share = torch.einsum("nchw,c->nhw", feat[:, 5:, :h1, :w1], other)
    scale = cellprob_noise / share.std().clamp(min=1e-30)
    head[2, 5:] = other * scale
    head_b[2] = -10.0 * cellprob_at - share.mean() * scale
    return sd


def weights(cfg: dict, traffic: dict, batches: list, nuclei: list, seed: int, device) -> dict:
    """The configuration's CPnet state dict from the seed: ``gradient_cpnet``
    on the run's first batch."""
    wcfg = cfg["weights"]
    if wcfg[SECTION] != "gradient_cpnet":
        raise ValueError(f"CPnet weights {wcfg[SECTION]!r}: only 'gradient_cpnet' is made here")
    return gradient_cpnet(cfg[SECTION], device, wcfg["gain"], wcfg["cellprob_at"], seed, wcfg["noise"],
                          batches[0], cfg["engine"]["diameter"], wcfg["cellprob_noise"])


# --------------------------------------------------------------------- FLOPs


def cpnet_conv_flops(features: tuple[int, ...], n_channels: int, size: int) -> float:
    """Forward FLOPs of one size x size tile through CPnet's convolutions,
    from the layer widths (2 per multiply-add; the style Linear layers and
    the elementwise work left out). Copy of ``chip_smoke.cpnet_conv_flops``."""
    nbase = [n_channels, *features]
    up = [*features, features[-1]]

    def block(cin, cout, side):  # proj 1x1, conv_0 3x3, conv_1..3 3x3
        return 2 * side * side * (cin * cout * (1 + 9) + 3 * cout * cout * 9)

    flops = sum(block(nbase[n], nbase[n + 1], size >> n) for n in range(len(features)))
    flops += sum(block(up[n], up[n - 1], size >> (n - 1)) for n in range(1, len(up)))
    return flops + 2 * size * size * up[0] * 3


def cpnet_site_flops(cp: dict, diameter: float, h: int, w: int) -> float:
    """CPnet's convolution FLOPs for one h x w site: the site rescaled by
    diam_mean / diameter and covered by tiles."""
    scale = cp["diam_mean"] / float(diameter)
    h1 = max(cp["tile"] // 4, int(round(h * scale)))
    w1 = max(cp["tile"] // 4, int(round(w * scale)))
    n = (len(tile_starts(max(h1, cp["tile"]), cp["tile"], cp["tile_overlap"]))
         * len(tile_starts(max(w1, cp["tile"]), cp["tile"], cp["tile_overlap"])))
    return n * cpnet_conv_flops(tuple(cp["features"]), cp["n_channels"], cp["tile"])


def flops(cfg: dict, traffic: dict) -> float:
    """FLOPs of one site of the traffic's size."""
    return cpnet_site_flops(cfg[SECTION], cfg["engine"]["diameter"], traffic["size"], traffic["size"])
