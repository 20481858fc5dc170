"""PyTorch/CUDA port of saguaro_tpu for NVIDIA Hopper GPUs.

The JAX package ``saguaro_tpu`` is the reference; this package mirrors its
module paths and public layouts (images ``(B, H, W, C)``, flows
``(B, 2, h, w)``, per-label tables ``(max_cells, K)``) and never imports it
or JAX. The TPU's Pallas kernels are CUDA kernels here
(``kernels/segment_cuda.py`` + ``csrc/``), each with a plain PyTorch twin
that serves CPU tensors. Entry points run on CUDA unless the caller passes
``device="cpu"``.

Ported so far: the feature-extraction path (CPnet segmentation -> flow
recovery -> CellProfiler-equivalent measurement at the shape, moment,
Zernike, intensity, edge, correlation, granularity and threshold families).
"""

from saguaro_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
