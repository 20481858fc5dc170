# Frozen copy of saguaro_tpu_torch/device.py (the port's plain forms), part of the
# benchmark's reference: CUDA dispatch removed, imports made local. Not edited
# when the program changes.
"""Device resolution shared by the port's entry points."""

from __future__ import annotations

import contextlib

import torch

__all__ = ["resolve_device", "full_f32", "on_device"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.

    With ``device=None`` and no visible CUDA device this raises instead of
    carrying on quietly on the CPU; pass ``device="cpu"`` to run the plain
    PyTorch forms there."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "hcs_bench.reference.plain runs on CUDA by default and no CUDA device is "
                "visible; pass device='cpu' to run the plain PyTorch forms"
            )
        return torch.device("cuda")
    return torch.device(device)


@contextlib.contextmanager
def full_f32():
    """Float32 matmuls and cuDNN convolutions in full f32 (no TF32) inside
    the block, as the reference computes them (``Precision.HIGHEST``); the
    caller's settings are restored after it."""
    matmul = torch.get_float32_matmul_precision()
    conv = torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(matmul)
        torch.backends.cudnn.allow_tf32 = conv


def on_device(device: torch.device):
    """A block in which ``device`` is the current CUDA device (kernels
    launched through the CUDA runtime, events and the current stream go
    there); a no-op for any other device."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()
