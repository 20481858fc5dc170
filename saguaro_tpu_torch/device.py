"""Device resolution shared by the port's entry points."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.

    With ``device=None`` and no visible CUDA device this raises instead of
    carrying on quietly on the CPU; pass ``device="cpu"`` to run the plain
    PyTorch forms there."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "saguaro_tpu_torch runs on CUDA by default and no CUDA device is "
                "visible; pass device='cpu' to run the plain PyTorch forms"
            )
        return torch.device("cuda")
    return torch.device(device)
