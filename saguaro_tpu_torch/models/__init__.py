"""Segmentation and embedding networks, their training, weight bridges and
checkpoints."""

from saguaro_tpu_torch.models.checkpoint import load_variables, save_variables

__all__ = ["load_variables", "save_variables"]
