"""The weights a cell runs with, made on the device by the benchmark and
handed to both the program and the reference as state dicts in cellpose's
and timm's key layout. Built with the reference's own definitions
(``reference/cellpose_ref``, ``reference/plain``), never with the
program's."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from hcs_bench.reference.plain.device import full_f32
from hcs_bench.reference.plain.kernels.crops import gather_crops
from hcs_bench.reference.plain.models.effnetv2 import EffNetV2, EffNetV2Config, StageSpec, preprocess_crops


def effnet_config(cfg: dict, compute_dtype: str | None = None) -> EffNetV2Config:
    e = cfg["effnet"]
    return EffNetV2Config(
        stem_filters=e["stem_filters"], head_filters=e["head_filters"], input_size=e["input_size"],
        compute_dtype=compute_dtype or e["compute_dtype"],
        stages=tuple(StageSpec(*s) for s in e["stages"]))


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
    from hcs_bench.reference.cellpose_ref import cpnet_features, cpnet_state, network_input

    sd = cpnet_state(cp, device)
    drawn = [k for k, v in sd.items() if k.endswith(".weight") and v.dim() >= 2]
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    flat = torch.randn(sum(sd[k].numel() for k in drawn), generator=gen, device=device)
    off = 0
    for k in drawn:
        t = sd[k]
        t.copy_(flat[off : off + t.numel()].view_as(t) * (noise / math.sqrt(t[0].numel())))
        off += t.numel()
    del flat
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


def calibration_crops(images: np.ndarray, labels: np.ndarray, n: int, box: int, device):
    """The first ``n`` (cell, channel) crops of one batch whose ``box``² box
    lies inside its site, cell-major and channel-minor: (n, box, box) f32."""
    b, h, w, n_ch = images.shape
    half = box // 2
    slots = []
    for s in range(b):
        for k in range(1, int(labels[s].max()) + 1):
            ys, xs = np.nonzero(labels[s] == k)
            if ys.size == 0:
                continue
            cy, cx = int(ys.mean()), int(xs.mean())
            if half <= cy <= h - half and half <= cx <= w - half:
                slots += [(s, k, c, cy, cx) for c in range(n_ch)]
            if len(slots) >= n:
                break
        if len(slots) >= n:
            break
    idx = torch.as_tensor(np.array(slots[:n]).T, device=device)
    chw = torch.as_tensor(images.astype(np.float32), device=device).permute(0, 3, 1, 2).contiguous()
    return gather_crops(chw, torch.as_tensor(labels, device=device), *idx, box=box)


@torch.no_grad()
def calibrated_effnet(ef_cfg: EffNetV2Config, seed: int, crops: torch.Tensor, size: int,
                      device, residual_scale: float = 1.0) -> dict:
    """An EfficientNetV2 state dict (unfolded, timm keys), after
    ``chip_smoke.calibrated_effnet``: convolution weights normal with
    variance 1/fan_in, drawn in one call of a generator on ``device`` seeded
    with ``seed``, zero biases; BatchNorm statistics those of one float32
    pass over ``crops`` at ``size``² (train mode, momentum 1), so that the
    activations stay of order one through the network's blocks. Then the
    last BatchNorm of every block with a skip connection is scaled by
    ``residual_scale``: each such block adds a scaled branch to its input,
    as in a trained network, where a random one amplifies any rounding
    through its depth until bfloat16 and fp8 give embeddings equally far
    from float32's."""
    with torch.device(device):
        model = EffNetV2(dataclasses.replace(ef_cfg, compute_dtype="float32", fold_bn=False))
    convs = [m for m in model.modules() if isinstance(m, torch.nn.Conv2d)]
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    flat = torch.randn(sum(m.weight.numel() for m in convs), generator=gen, device=device)
    off = 0
    for m in convs:
        k = m.weight.numel()
        m.weight.copy_(flat[off : off + k].view_as(m.weight) / math.sqrt(m.weight[0].numel()))
        off += k
        if m.bias is not None:
            m.bias.zero_()
    del flat
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = 1.0
    model.train()
    with full_f32():
        model(preprocess_crops(crops, size, n_channels=3))
    for stage in model.blocks:
        for block in stage:
            if block.has_skip:
                last = getattr(block, block.pairs[-1][1])
                last.weight.mul_(residual_scale)
                last.bias.mul_(residual_scale)
    return model.eval().state_dict()
