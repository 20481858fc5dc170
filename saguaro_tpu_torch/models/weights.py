"""Weight bridge: the JAX package's flax CellposeUNet variables -> this
package's CellposeUNet state dict.

The inverse of the reference's checkpoint conversion
(``saguaro_tpu/models/weights.py`` layout converters under
``saguaro_tpu/models/cellpose_weights.cellpose_name_map``): both packages
can then run identical weights without a checkpoint file. The name map is
copied here so that this package imports nothing of the JAX one.
"""

from __future__ import annotations

import numpy as np
import torch

from saguaro_tpu_torch.models.cellpose import CellposeConfig

__all__ = ["cellpose_name_map", "cellpose_state_dict_from_flax"]


def cellpose_name_map(config: CellposeConfig = CellposeConfig()) -> dict[str, str]:
    """{flax flat key: CPnet state-dict key} for every parameter (cellpose
    resnet_torch naming; BatchNorm scale/bias/mean/var map to
    weight/bias/running_mean/running_var)."""
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


def _flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}
    if isinstance(tree, dict) or hasattr(tree, "items"):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def cellpose_state_dict_from_flax(
    variables_as_numpy: dict, config: CellposeConfig = CellposeConfig()
) -> dict[str, torch.Tensor]:
    """flax ``{'params': ..., 'batch_stats': ...}`` tree of numpy arrays ->
    CPnet state dict. Conv kernels (kh, kw, I, O) -> (O, I, kh, kw); Dense
    kernels (in, out) -> (out, in); vectors copy. Every mapped key must be
    present."""
    flat = _flatten(variables_as_numpy)
    sd: dict[str, torch.Tensor] = {}
    for fkey, tkey in cellpose_name_map(config).items():
        a = np.asarray(flat[fkey], np.float32)
        if a.ndim == 4:
            a = np.transpose(a, (3, 2, 0, 1))
        elif a.ndim == 2:
            a = a.T
        sd[tkey] = torch.from_numpy(np.ascontiguousarray(a))
    return sd
