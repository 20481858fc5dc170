"""PyTorch/CUDA port of saguaro_tpu for NVIDIA Hopper GPUs.

The JAX package ``saguaro_tpu`` is the reference; this package mirrors its
module paths and public layouts (images ``(B, H, W, C)``, flows
``(B, 2, h, w)``, per-label tables ``(max_cells, K)``) and never imports it
or JAX. The TPU's Pallas kernels are CUDA kernels here
(``kernels/segment_cuda.py``, ``kernels/resample_cuda.py`` + ``csrc/``),
each with a plain PyTorch twin that serves CPU tensors. Entry points run
on CUDA unless the caller passes ``device="cpu"``.

Ported so far: the feature-extraction path (CPnet segmentation -> flow
recovery -> CellProfiler-equivalent measurement at the reference's
default FeatureConfig) with its job grid (``pipeline/feature_extraction``),
the embed stage and segment-embed driver, the pixel stages (max
projection -> Lanczos re-binning -> illumination estimate -> image QC,
``pipeline/pixel_stages``), the profile-and-hits tail (``ops``,
``pipeline/profile_stages``, ``pipeline/hits``) and their CLIs (``cli/``).
"""

from saguaro_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
