"""Cellpose checkpoints: a CPnet torch state dict -> a ``CellposeUNet`` state
dict (port of ``saguaro_tpu/models/cellpose_weights.py``), and the name map
between CPnet's keys and the JAX package's flax tree.

``CellposeUNet`` carries CPnet's own keys, so "converting" a cellpose file
here means unwrapping it: wrappers and their key prefixes go, and so do the
diameters newer files store beside the weights (``diam_mean``,
``diam_labels``). The name map serves the flax side: the JAX package's
variables bridged onto this network (``cellpose_state_dict_from_flax``) and
its checkpoint format (``models/checkpoint.py``).

Checkpoint facts: cellpose model files are torch ``state_dict`` saves; the
'nuclei' model has nbase [2, 32, 64, 128, 256], 3 outputs, 3x3
convolutions and diam_mean 17.0 (the cyto models 30.0): pass
``CellposeConfig(diam_mean=17.0)`` with it.
"""

from __future__ import annotations

import torch

from saguaro_tpu_torch.models.cellpose import CellposeConfig
from saguaro_tpu_torch.models.weights import read_torch_state_dict, state_dict_from_flax, strip_prefixes

__all__ = [
    "cellpose_name_map",
    "convert_cellpose_state_dict",
    "load_torch_cellpose",
    "cellpose_state_dict_from_flax",
]

# stored by newer cellpose files beside the weights; not weights
_NOT_WEIGHTS = ("diam_mean", "diam_labels")


def cellpose_name_map(config: CellposeConfig = CellposeConfig()) -> dict[str, str]:
    """{flax flat key: CPnet state-dict key} for every parameter.

    CPnet key anatomy (cellpose resnet_torch naming):
      downsample.down.res_down_{n}.proj.{0,1}       batchconv0: BN, Conv1x1
      downsample.down.res_down_{n}.conv.conv_{t}.{0,2}  batchconv: BN, Conv3x3
      upsample.up.res_up_{n}.proj.{0,1}
      upsample.up.res_up_{n}.conv.conv_0.{0,2}
      upsample.up.res_up_{n}.conv.conv_{1..3}.conv.{0,2} + .full (style Linear)
      output.{0,2}                                  batchconv head
    BatchNorm scale/bias/mean/var map to weight/bias/running_mean/running_var.
    """
    m: dict[str, str] = {}

    def bn(flax_prefix: str, torch_prefix: str) -> None:
        m[f"params/{flax_prefix}/scale"] = f"{torch_prefix}.weight"
        m[f"params/{flax_prefix}/bias"] = f"{torch_prefix}.bias"
        m[f"batch_stats/{flax_prefix}/mean"] = f"{torch_prefix}.running_mean"
        m[f"batch_stats/{flax_prefix}/var"] = f"{torch_prefix}.running_var"

    def conv(flax_prefix: str, torch_prefix: str) -> None:
        m[f"params/{flax_prefix}/kernel"] = f"{torch_prefix}.weight"
        m[f"params/{flax_prefix}/bias"] = f"{torch_prefix}.bias"

    for n in range(len(config.features)):
        fd, td = f"res_down_{n}", f"downsample.down.res_down_{n}"
        bn(f"{fd}/proj/bn", f"{td}.proj.0")
        conv(f"{fd}/proj/conv", f"{td}.proj.1")
        for t in range(4):
            bn(f"{fd}/conv_{t}/bn", f"{td}.conv.conv_{t}.0")
            conv(f"{fd}/conv_{t}/conv", f"{td}.conv.conv_{t}.2")

        fu, tu = f"res_up_{n}", f"upsample.up.res_up_{n}"
        bn(f"{fu}/proj/bn", f"{tu}.proj.0")
        conv(f"{fu}/proj/conv", f"{tu}.proj.1")
        bn(f"{fu}/conv_0/bn", f"{tu}.conv.conv_0.0")
        conv(f"{fu}/conv_0/conv", f"{tu}.conv.conv_0.2")
        for t in range(1, 4):
            bn(f"{fu}/conv_{t}/conv/bn", f"{tu}.conv.conv_{t}.conv.0")
            conv(f"{fu}/conv_{t}/conv/conv", f"{tu}.conv.conv_{t}.conv.2")
            m[f"params/{fu}/conv_{t}/full/kernel"] = f"{tu}.conv.conv_{t}.full.weight"
            m[f"params/{fu}/conv_{t}/full/bias"] = f"{tu}.conv.conv_{t}.full.bias"

    bn("output/bn", "output.0")
    conv("output/conv", "output.2")
    return m


def convert_cellpose_state_dict(state_dict: dict) -> dict[str, torch.Tensor]:
    """A cellpose CPnet state dict (tensors or numpy arrays) -> a
    ``CellposeUNet`` state dict: the wrappers' key prefixes stripped, the
    stored diameters dropped. Loading it into the network checks its keys
    and shapes."""
    return {k: torch.as_tensor(v) for k, v in strip_prefixes(dict(state_dict)).items()
            if k not in _NOT_WEIGHTS}


def load_torch_cellpose(path: str) -> dict[str, torch.Tensor]:
    """A cellpose model FILE (a torch save, local or through ``io.storage``;
    bare or under a ``state_dict``/``model`` wrapper) -> a ``CellposeUNet``
    state dict on the CPU. Unpickles tensors only (``weights_only=True``)."""
    return convert_cellpose_state_dict(read_torch_state_dict(path))


def cellpose_state_dict_from_flax(
    variables_as_numpy: dict, config: CellposeConfig = CellposeConfig()
) -> dict[str, torch.Tensor]:
    """The JAX package's ``{'params': ..., 'batch_stats': ...}`` tree of numpy
    arrays -> a ``CellposeUNet`` state dict: convolution kernels (kh, kw, I,
    O) -> (O, I, kh, kw), the style Linear kernels (in, out) -> (out, in)
    (square ones too), vectors as they are."""
    return state_dict_from_flax(variables_as_numpy, cellpose_name_map(config))
