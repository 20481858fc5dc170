"""Segment reductions, measurement kernels, the pixel-stage kernels and their CUDA forms.

The package exports the reference's public kernel API. Importing it builds
no CUDA source: the kernels build at their first launch."""

from saguaro_tpu_torch.kernels.crops import extract_crops, label_centroids
from saguaro_tpu_torch.kernels.flow_ode import (
    compute_masks,
    compute_masks_batch,
    follow_flows,
    follow_flows_pointer,
)
from saguaro_tpu_torch.kernels.glcm import haralick_features, object_glcm
from saguaro_tpu_torch.kernels.illum import estimate_illumination, illum_correct
from saguaro_tpu_torch.kernels.maxproj import max_project, max_project_batch
from saguaro_tpu_torch.kernels.qc import qc_metrics, qc_metrics_batch, radial_power_spectrum
from saguaro_tpu_torch.kernels.resample import (
    lanczos_matrices,
    lanczos_resize,
    lanczos_resize_batch,
)
from saguaro_tpu_torch.kernels.segment_reduce import (
    correlation_features,
    intensity_features,
    shape_features,
)
from saguaro_tpu_torch.kernels.zernike import zernike_features

__all__ = [
    "max_project",
    "max_project_batch",
    "lanczos_resize",
    "lanczos_resize_batch",
    "lanczos_matrices",
    "illum_correct",
    "estimate_illumination",
    "qc_metrics",
    "qc_metrics_batch",
    "radial_power_spectrum",
    "compute_masks",
    "compute_masks_batch",
    "follow_flows",
    "follow_flows_pointer",
    "extract_crops",
    "label_centroids",
    "haralick_features",
    "object_glcm",
    "correlation_features",
    "intensity_features",
    "shape_features",
    "zernike_features",
]
