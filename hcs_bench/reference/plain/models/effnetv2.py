# Frozen copy of saguaro_tpu_torch/models/effnetv2.py (the port's plain forms), part of the
# benchmark's reference: CUDA dispatch removed, imports made local. Not edited
# when the program changes.
"""EfficientNetV2 feature extractor (port of ``saguaro_tpu/models/effnetv2.py``).

The reference's embedding engine is ``timm/tf_efficientnetv2_l.in21k``'s
pooled output (Cellpose_GPU_s3fs.py:27,109-110,191-194): each 200 x 200
masked cell crop, one channel at a time, is min-max scaled to 8 bits,
resized to 480² and embedded to a 1280-d vector.

``EffNetV2`` maps (N, C, H, W) to (N, 1280). Its parameters carry timm's
key layout (``conv_stem``, ``bn1``, ``blocks.{s}.{i}.conv_exp`` ...,
``conv_head``, ``bn2``), so a timm or transformers checkpoint loads with
``load_state_dict``; ``models/weights`` bridges the JAX package's flax
variables onto the same keys. Its numerics follow the flax module's:
TF-SAME padding (more at the end on stride-2 convolutions of even
inputs), BatchNorm eps 1e-3 in f32, activations cast to the compute dtype
after every conv-BN-SiLU, the squeeze-excitation path and the pooled mean
in f32. The convolutions are cuDNN's: the JAX package left them to XLA
(its two Pallas conv kernels were pruned, ``effnetv2.py:166-171``,
``:247-253``).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from functools import lru_cache

import torch
import torch.nn as nn
import torch.nn.functional as F

from hcs_bench.reference.plain.device import full_f32, resolve_device
from hcs_bench.reference.plain.kernels.resample import bicubic_axis_matrix

__all__ = [
    "StageSpec",
    "EffNetV2Config",
    "EFFNETV2_S",
    "EFFNETV2_M",
    "EFFNETV2_L",
    "EffNetV2",
    "init_effnetv2",
    "fold_batchnorm",
    "fold_rgb_stem",
    "preprocess_crops",
    "embed_crops",
]

BN_EPS = 1e-3  # tf_efficientnetv2's BatchNorm epsilon


@dataclass(frozen=True)
class StageSpec:
    block: str          # "fused" | "mbconv"
    expand: int
    kernel: int
    stride: int
    filters: int
    count: int
    se_ratio: float = 0.0


@dataclass(frozen=True)
class EffNetV2Config:
    stem_filters: int
    stages: tuple[StageSpec, ...]
    head_filters: int = 1280
    input_size: int = 480
    compute_dtype: str = "bfloat16"
    # Inference BN folded into the convolutions (``fold_batchnorm``): the
    # convs carry a bias and the BatchNorms are gone.
    fold_bn: bool = False


EFFNETV2_S = EffNetV2Config(
    stem_filters=24,
    stages=(
        StageSpec("fused", 1, 3, 1, 24, 2),
        StageSpec("fused", 4, 3, 2, 48, 4),
        StageSpec("fused", 4, 3, 2, 64, 4),
        StageSpec("mbconv", 4, 3, 2, 128, 6, 0.25),
        StageSpec("mbconv", 6, 3, 1, 160, 9, 0.25),
        StageSpec("mbconv", 6, 3, 2, 256, 15, 0.25),
    ),
    input_size=384,
)

EFFNETV2_M = EffNetV2Config(
    stem_filters=24,
    stages=(
        StageSpec("fused", 1, 3, 1, 24, 3),
        StageSpec("fused", 4, 3, 2, 48, 5),
        StageSpec("fused", 4, 3, 2, 80, 5),
        StageSpec("mbconv", 4, 3, 2, 160, 7, 0.25),
        StageSpec("mbconv", 6, 3, 1, 176, 14, 0.25),
        StageSpec("mbconv", 6, 3, 2, 304, 18, 0.25),
        StageSpec("mbconv", 6, 3, 1, 512, 5, 0.25),
    ),
    input_size=480,
)

EFFNETV2_L = EffNetV2Config(
    stem_filters=32,
    stages=(
        StageSpec("fused", 1, 3, 1, 32, 4),
        StageSpec("fused", 4, 3, 2, 64, 7),
        StageSpec("fused", 4, 3, 2, 96, 7),
        StageSpec("mbconv", 4, 3, 2, 192, 10, 0.25),
        StageSpec("mbconv", 6, 3, 1, 224, 19, 0.25),
        StageSpec("mbconv", 6, 3, 2, 384, 25, 0.25),
        StageSpec("mbconv", 6, 3, 1, 640, 7, 0.25),
    ),
    input_size=480,
)


def _dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}[name]


def same_padding(size: int, k: int, stride: int) -> tuple[int, int]:
    """TF/flax "SAME" padding of one axis: (before, after), the odd pixel
    after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x, conv: nn.Conv2d, dtype: torch.dtype):
    """``conv`` in ``dtype`` with SAME padding. The bias, where the conv has
    one, is added to the rounded output in ``dtype`` (PyTorch adds it after
    the convolution, as flax does)."""
    k, s = conv.kernel_size[0], conv.stride[0]
    if s == 1:
        pad = k // 2
    else:
        top, bottom = same_padding(x.shape[-2], k, s)
        left, right = same_padding(x.shape[-1], k, s)
        x = F.pad(x, (left, right, top, bottom))
        pad = 0
    bias = conv.bias.to(dtype) if conv.bias is not None else None
    return F.conv2d(x.to(dtype), conv.weight.to(dtype), bias, s, pad, 1, conv.groups)


def _conv_bn_act(x, conv, bn, dtype, act: bool = True):
    """The flax ``_ConvBNAct``: conv in ``dtype``, BatchNorm (when not
    folded) in f32, SiLU, cast back to ``dtype``."""
    y = _conv(x, conv, dtype)
    if bn is not None:
        # in train mode (a calibration pass) the batch's statistics
        # normalize and update the running ones, as nn.BatchNorm2d's
        y = F.batch_norm(y.float(), bn.running_mean, bn.running_var, bn.weight, bn.bias,
                         bn.training, bn.momentum, bn.eps)
    return (F.silu(y) if act else y).to(dtype)


def _conv2d(cin, cout, k, stride=1, groups=1, bias=False) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, groups=groups, bias=bias)


def _bn(c: int, folded: bool):
    return None if folded else nn.BatchNorm2d(c, eps=BN_EPS)


class _FusedBlock(nn.Module):
    """timm ``ConvBnAct`` (expand 1: ``conv``/``bn1``) or ``EdgeResidual``
    (``conv_exp``/``bn1``, ``conv_pwl``/``bn2``); the flax ``_FusedMBConv``."""

    def __init__(self, cin: int, spec: StageSpec, stride: int, folded: bool):
        super().__init__()
        self.has_skip = stride == 1 and cin == spec.filters
        if spec.expand == 1:
            self.conv = _conv2d(cin, spec.filters, spec.kernel, stride, bias=folded)
            self.bn1 = _bn(spec.filters, folded)
            self.pairs = (("conv", "bn1"),)
        else:
            mid = cin * spec.expand
            self.conv_exp = _conv2d(cin, mid, spec.kernel, stride, bias=folded)
            self.bn1 = _bn(mid, folded)
            self.conv_pwl = _conv2d(mid, spec.filters, 1, bias=folded)
            self.bn2 = _bn(spec.filters, folded)
            self.pairs = (("conv_exp", "bn1"), ("conv_pwl", "bn2"))

    def forward(self, x, dtype):
        if len(self.pairs) == 1:
            h = _conv_bn_act(x, self.conv, self.bn1, dtype)
        else:
            h = _conv_bn_act(x, self.conv_exp, self.bn1, dtype)
            h = _conv_bn_act(h, self.conv_pwl, self.bn2, dtype, act=False)
        return h + x if self.has_skip else h


class _SE(nn.Module):
    """timm ``SqueezeExcite`` (``conv_reduce``, ``conv_expand``), in f32."""

    def __init__(self, mid: int, rd: int):
        super().__init__()
        self.conv_reduce = nn.Conv2d(mid, rd, 1)
        self.conv_expand = nn.Conv2d(rd, mid, 1)

    def forward(self, x):
        mean = x.float().mean((2, 3))
        s = F.silu(F.linear(mean, self.conv_reduce.weight.flatten(1), self.conv_reduce.bias))
        s = F.linear(s, self.conv_expand.weight.flatten(1), self.conv_expand.bias)
        return x * torch.sigmoid(s).to(x.dtype)[:, :, None, None]


class _MBConvBlock(nn.Module):
    """timm ``InvertedResidual`` (``conv_pw``/``bn1``, ``conv_dw``/``bn2``,
    ``se``, ``conv_pwl``/``bn3``); the flax ``_MBConv``."""

    def __init__(self, cin: int, spec: StageSpec, stride: int, folded: bool):
        super().__init__()
        mid = cin * spec.expand
        self.has_skip = stride == 1 and cin == spec.filters
        self.conv_pw = _conv2d(cin, mid, 1, bias=folded)
        self.bn1 = _bn(mid, folded)
        self.conv_dw = _conv2d(mid, mid, spec.kernel, stride, groups=mid, bias=folded)
        self.bn2 = _bn(mid, folded)
        self.se = _SE(mid, max(1, int(cin * spec.se_ratio))) if spec.se_ratio > 0 else None
        self.conv_pwl = _conv2d(mid, spec.filters, 1, bias=folded)
        self.bn3 = _bn(spec.filters, folded)
        self.pairs = (("conv_pw", "bn1"), ("conv_dw", "bn2"), ("conv_pwl", "bn3"))

    def forward(self, x, dtype):
        h = _conv_bn_act(x, self.conv_pw, self.bn1, dtype)
        h = _conv_bn_act(h, self.conv_dw, self.bn2, dtype)
        if self.se is not None:
            h = self.se(h)
        h = _conv_bn_act(h, self.conv_pwl, self.bn3, dtype, act=False)
        return h + x if self.has_skip else h


class EffNetV2(nn.Module):
    """(N, C, H, W) -> (N, head_filters) f32 pooled features (the
    'pooler_output'); C is 3, or 1 after ``fold_rgb_stem``."""

    def __init__(self, config: EffNetV2Config = EFFNETV2_L):
        super().__init__()
        self.config = config
        folded = config.fold_bn
        self.conv_stem = _conv2d(3, config.stem_filters, 3, 2, bias=folded)
        self.bn1 = _bn(config.stem_filters, folded)
        self.blocks = nn.ModuleList()
        cin = config.stem_filters
        for spec in config.stages:
            stage = nn.ModuleList()
            for i in range(spec.count):
                stride = spec.stride if i == 0 else 1
                block = _FusedBlock if spec.block == "fused" else _MBConvBlock
                stage.append(block(cin, spec, stride, folded))
                cin = spec.filters
            self.blocks.append(stage)
        self.conv_head = _conv2d(cin, config.head_filters, 1, bias=folded)
        self.bn2 = _bn(config.head_filters, folded)
        self.pairs = (("conv_stem", "bn1"), ("conv_head", "bn2"))

    def forward(self, x):
        dtype = _dtype(self.config.compute_dtype)
        x = _conv_bn_act(x.to(dtype), self.conv_stem, self.bn1, dtype)
        for stage in self.blocks:
            for block in stage:
                x = block(x, dtype)
        x = _conv_bn_act(x, self.conv_head, self.bn2, dtype)
        return x.float().mean((2, 3))


def init_effnetv2(config: EffNetV2Config = EFFNETV2_L, seed: int = 0,
                  device: str | torch.device | None = None) -> EffNetV2:
    """An EffNetV2 in eval mode on ``device`` (CUDA unless the caller names
    one) with random weights drawn from a seeded generator on the CPU, at
    the flax defaults' scale: convolution weights normal with variance
    1/fan_in, zero biases, BatchNorm at identity statistics."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    model = EffNetV2(config)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen) / math.sqrt(fan_in))
                if m.bias is not None:
                    m.bias.zero_()
    return model.eval().to(device)


def _conv_bn_pairs(model: EffNetV2):
    for owner in [model, *(b for stage in model.blocks for b in stage)]:
        for conv_name, bn_name in owner.pairs:
            yield owner, getattr(owner, conv_name), bn_name


@torch.no_grad()
def fold_batchnorm(model: EffNetV2) -> EffNetV2:
    """Fold the inference-mode BatchNorms into their convolutions, in place,
    on the device the weights lie on:

        W' = W * gamma / sqrt(var + eps)      (per output channel)
        b' = beta - mean * gamma / sqrt(var + eps)

    The BatchNorms go (their keys leave the state dict), each conv gains a
    bias, and ``model.config.fold_bn`` becomes True. Exact in f32; under
    bf16 compute the folded graph rounds once where the unfolded rounded
    twice. A folded model is returned unchanged."""
    if model.config.fold_bn:
        return model
    for owner, conv, bn_name in _conv_bn_pairs(model):
        bn = getattr(owner, bn_name)
        scale = bn.weight / torch.sqrt(bn.running_var + bn.eps)
        conv.weight.mul_(scale[:, None, None, None])
        conv.bias = nn.Parameter(bn.bias - bn.running_mean * scale)
        setattr(owner, bn_name, None)
    model.config = dataclasses.replace(model.config, fold_bn=True)
    return model


@torch.no_grad()
def fold_rgb_stem(model: EffNetV2) -> EffNetV2:
    """Fold the stem conv's RGB input weights into one channel, in place.

    The embed pipeline replicates each gray crop to RGB
    (Cellpose_GPU_s3fs.py:177-182), so conv(x, x, x) = (W_r + W_g + W_b) * x
    exactly and the network takes (N, 1, H, W). Idempotent: a stem that is
    already single-channel is left as it is."""
    stem = model.conv_stem
    if stem.weight.shape[1] != 1:
        stem.weight = nn.Parameter(stem.weight.sum(dim=1, keepdim=True))
        stem.in_channels = 1
    return model


# ----------------------------------------------------------------------------
# Crop preprocessing: the reference's scale_to_8bit + RGB + processor chain


@lru_cache(maxsize=8)
def _axis_matrix(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(bicubic_axis_matrix(in_size, out_size), device=device)


def preprocess_crops(crops: torch.Tensor, out_size: int = 480, n_channels: int = 3) -> torch.Tensor:
    """(N, H, W) single-channel crops -> (N, n_channels, out, out) f32 model
    inputs (``n_channels=1`` for a ``fold_rgb_stem`` network).

    The reference's chain (Cellpose_GPU_s3fs.py:34-43,177-182,191-194):
    per crop min-max scale to [0, 255] (a flat crop maps to 0) and floor to
    uint8 steps; PIL's bicubic resize to ``out_size``, horizontal pass
    first, the intermediate clipped and rounded to uint8 steps, then the
    vertical pass, clipped and rounded; Normalize(mean=0.5, std=0.5).
    ``torch.round`` rounds half to even, as ``jnp.round``. The two passes
    are f32 matrix products in full f32."""
    x = crops.float()
    n, h, w = x.shape
    mn = x.amin(dim=(1, 2), keepdim=True)
    mx = x.amax(dim=(1, 2), keepdim=True)
    flat = mx == mn
    scaled = torch.where(flat, 0.0, 255.0 * (x - mn) / torch.where(flat, 1.0, mx - mn))
    scaled = torch.floor(scaled)
    wh = _axis_matrix(w, out_size, x.device)  # (out, w)
    wv = _axis_matrix(h, out_size, x.device)  # (out, h)
    with full_f32():
        horiz = torch.round(torch.clamp(scaled @ wh.T, 0.0, 255.0))       # (n, h, out)
        resized = torch.round(torch.clamp(wv @ horiz, 0.0, 255.0))        # (n, out, out)
    normed = (resized / 255.0 - 0.5) / 0.5
    return normed[:, None].expand(n, n_channels, out_size, out_size)


def embed_crops(model: EffNetV2, crops: torch.Tensor, out_size: int = 480) -> torch.Tensor:
    """(N, H, W) crops -> (N, 1280) embeddings."""
    n_in = model.conv_stem.weight.shape[1]
    return model(preprocess_crops(crops, out_size, n_channels=n_in))
