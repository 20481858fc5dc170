"""EfficientNetV2 as an embedder of the benchmark: its weights from the
seed, its FLOPs a crop, and its forward pass from the frozen plain copy
(``reference/plain/models/effnetv2.py``), unfolded.

The configuration's ``effnet`` section holds its stage table and sizes and
the dotted path of the program's config class; ``weights`` holds the
draw's parameters (``random_calibrated``)."""

from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch

from hcs_bench.reference.plain.device import full_f32
from hcs_bench.reference.plain.kernels.crops import gather_crops
from hcs_bench.reference.plain.models.effnetv2 import EffNetV2, EffNetV2Config, StageSpec, preprocess_crops
from hcs_bench.reference.precision import fp8_convolutions
from hcs_bench.traffic.generator import nuclei_labels
from hcs_bench.weights import draw_normal

SECTION = "effnet"


def effnet_config(cfg: dict, compute_dtype: str | None = None) -> EffNetV2Config:
    e = cfg[SECTION]
    return EffNetV2Config(
        stem_filters=e["stem_filters"], head_filters=e["head_filters"], input_size=e["input_size"],
        compute_dtype=compute_dtype or e["compute_dtype"],
        stages=tuple(StageSpec(*s) for s in e["stages"]))


# ------------------------------------------------------------------ network


def forward(cfg: dict, state: dict, device, lower: bool = False):
    """The reference's embedding of (n, box, box) f32 masked crops -> (n,
    1280): the crops resized to the engine's ``embed_size`` and replicated
    to RGB, through EfficientNetV2 in float32, or, with ``lower``, the
    control's precision (bfloat16, convolutions on inputs and weights
    rounded to fp8 e4m3)."""
    with torch.device(device):
        net = EffNetV2(effnet_config(cfg, "bfloat16" if lower else "float32"))
    net.load_state_dict(state, strict=False)
    net.eval()
    size = cfg["engine"]["embed_size"]

    @torch.no_grad()
    def run(crops: torch.Tensor) -> torch.Tensor:
        with fp8_convolutions() if lower else contextlib.nullcontext():
            return net(preprocess_crops(crops, size, n_channels=3))

    return run


# ------------------------------------------------------------------ weights


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
    draw_normal([m.weight for m in convs], seed, device, lambda x, t: x / math.sqrt(t[0].numel()))
    for m in convs:
        if m.bias is not None:
            m.bias.zero_()
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


def weights(cfg: dict, traffic: dict, batches: list, nuclei: list, seed: int, device) -> dict:
    """The configuration's EfficientNetV2 state dict from the seed:
    ``calibrated_effnet`` over the first crops of the run's first batch,
    cut around the placed nuclei."""
    wcfg, eng = cfg["weights"], cfg["engine"]
    if wcfg[SECTION] != "random_calibrated":
        raise ValueError(f"EfficientNetV2 weights {wcfg[SECTION]!r}: only 'random_calibrated' is made here")
    lab0 = np.stack([nuclei_labels(traffic, c) for c in nuclei[0]])
    crops = calibration_crops(batches[0], lab0, wcfg["calibration_crops"], eng["box_size"], device)
    return calibrated_effnet(effnet_config(cfg), seed, crops, eng["embed_size"], device,
                             wcfg["residual_scale"])


# --------------------------------------------------------------------- FLOPs


def effnet_cost(ef: dict, size: int, in_ch: int = 1) -> tuple[int, int]:
    """(multiply-adds, bytes) of one crop through an EfficientNetV2 stage
    table at size²: every convolution's MACs (depthwise ones per group),
    the squeeze-excitation products, and the bytes of every convolution's
    output written once and read once in bf16 plus the f32 input read
    once. Copy of ``chip_smoke.effnet_cost``."""
    macs = elems = 0
    n = size

    def conv(cin, cout, k, s, groups=1):
        nonlocal n, macs, elems
        n = -(-n // s)
        macs += n * n * cout * (cin // groups) * k * k
        elems += n * n * cout

    conv(in_ch, ef["stem_filters"], 3, 2)
    cin = ef["stem_filters"]
    for block, expand, kernel, stride, filters, count, se_ratio in ef["stages"]:
        for i in range(count):
            s = stride if i == 0 else 1
            mid = cin * expand
            if block == "fused" and expand == 1:
                conv(cin, filters, kernel, s)
            elif block == "fused":
                conv(cin, mid, kernel, s)
                conv(mid, filters, 1, 1)
            else:
                conv(cin, mid, 1, 1)
                conv(mid, mid, kernel, s, groups=mid)
                macs += 2 * mid * max(1, int(cin * se_ratio))
                conv(mid, filters, 1, 1)
            cin = filters
    conv(cin, ef["head_filters"], 1, 1)
    return macs, 4 * elems + 4 * size * size * in_ch


def flops(cfg: dict, traffic: dict) -> float:
    """FLOPs of one crop at the engine's ``embed_size``, as RGB."""
    return 2.0 * effnet_cost(cfg[SECTION], cfg["engine"]["embed_size"], in_ch=3)[0]
