"""Segmentation and embedding networks, their training, weight bridges and
checkpoints."""

from saguaro_tpu_torch.models.cellpose import (
    CellposeConfig,
    CellposeUNet,
    init_cellpose,
    segment_image,
    segment_image_batch,
    segment_tiles,
)
from saguaro_tpu_torch.models.checkpoint import load_variables, save_variables
from saguaro_tpu_torch.models.effnetv2 import (
    EFFNETV2_L,
    EFFNETV2_M,
    EFFNETV2_S,
    EffNetV2,
    EffNetV2Config,
    init_effnetv2,
)
from saguaro_tpu_torch.models.xgb import XGBEnsemble

__all__ = [
    "CellposeUNet",
    "CellposeConfig",
    "init_cellpose",
    "segment_image",
    "segment_image_batch",
    "segment_tiles",
    "EffNetV2",
    "EffNetV2Config",
    "EFFNETV2_S",
    "EFFNETV2_M",
    "EFFNETV2_L",
    "init_effnetv2",
    "XGBEnsemble",
    "load_variables",
    "save_variables",
]
