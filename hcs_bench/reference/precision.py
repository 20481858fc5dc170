"""The roundings of the controls' lower precisions, put on the reference in
the program's place: a tensor rounded to fp8 (e4m3) under one scale, for a
network the configuration runs in bfloat16 (each network's module,
``networks/<name>.py``, picks what its control rounds: ``fp8_convolutions``
for a convolutional one), and the measurement's image planes held in
bfloat16 where the configuration measures in float32."""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to e4m3 under one per-tensor scale (its largest
    magnitude onto e4m3's largest finite value), back in bfloat16."""
    scale = t.detach().abs().amax().float().clamp(min=1e-30) / FP8_MAX
    return ((t.float() / scale).to(FP8).float() * scale).to(torch.bfloat16)


@contextlib.contextmanager
def fp8_convolutions():
    """Inside the block every ``F.conv2d`` call rounds its input and weight
    to e4m3 and convolves in bfloat16 (the bias in bfloat16)."""
    real = F.conv2d

    def conv2d(x, weight, bias=None, *args, **kw):
        out = real(fp8(x), fp8(weight), None if bias is None else bias.to(torch.bfloat16), *args, **kw)
        return out.to(x.dtype)

    F.conv2d = conv2d
    try:
        yield
    finally:
        F.conv2d = real


def bf16_planes(images: np.ndarray) -> np.ndarray:
    """uint16 planes rounded to bfloat16 (8 significant bits), as int32:
    still whole numbers, so the measurement's integer grid holds."""
    t = torch.as_tensor(images.astype(np.float32)).to(torch.bfloat16).float()
    return t.numpy().astype(np.int32)
