"""Weight bridge: the JAX package's flax variables -> this package's state
dicts (CellposeUNet and EffNetV2), and the torch checkpoint files both
networks take.

The inverse of the reference's checkpoint conversion
(``saguaro_tpu/models/weights.py`` layout converters under
``cellpose_weights.cellpose_name_map`` and
``effnet_weights.effnet_name_map``): both packages can then run identical
weights without a checkpoint file. The name maps are copied here so that
this package imports nothing of the JAX one.
"""

from __future__ import annotations

import io

import numpy as np
import torch

from saguaro_tpu_torch.io import storage
from saguaro_tpu_torch.models.cellpose import CellposeConfig
from saguaro_tpu_torch.models.effnetv2 import EFFNETV2_L, EffNetV2Config

__all__ = [
    "cellpose_name_map",
    "cellpose_state_dict_from_flax",
    "effnet_name_map",
    "effnet_state_dict_from_flax",
    "load_cellpose_checkpoint",
    "load_effnet_checkpoint",
]

# wrappers' key prefixes (transformers' TimmWrapperModel, DataParallel, ...)
_PREFIXES = ("timm_model.", "module.", "model.")
# the JAX package's own checkpoint format (``saguaro_tpu/models/checkpoint.py``)
_FLAX_MAGIC = b"SGTPU1\n"


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


def _state_dict_from_flax(variables_as_numpy: dict, name_map: dict[str, str]) -> dict[str, torch.Tensor]:
    """Conv kernels (kh, kw, I, O) -> (O, I, kh, kw) (depthwise (kh, kw, 1,
    C) -> (C, 1, kh, kw) by the same transpose); Dense kernels (in, out) ->
    (out, in); vectors copy. Every mapped key must be present."""
    flat = _flatten(variables_as_numpy)
    sd: dict[str, torch.Tensor] = {}
    for fkey, tkey in name_map.items():
        a = np.asarray(flat[fkey], np.float32)
        if a.ndim == 4:
            a = np.transpose(a, (3, 2, 0, 1))
        elif a.ndim == 2:
            a = a.T
        sd[tkey] = torch.from_numpy(np.ascontiguousarray(a))
    return sd


def cellpose_state_dict_from_flax(
    variables_as_numpy: dict, config: CellposeConfig = CellposeConfig()
) -> dict[str, torch.Tensor]:
    """flax ``{'params': ..., 'batch_stats': ...}`` tree of numpy arrays ->
    CPnet state dict."""
    return _state_dict_from_flax(variables_as_numpy, cellpose_name_map(config))


def effnet_name_map(config: EffNetV2Config = EFFNETV2_L) -> dict[str, str]:
    """{flax flat key: timm key} for every parameter of the config (flax
    linen auto-naming of the reference's modules: ``_ConvBNAct_0`` stem,
    ``_FusedMBConv_i``/``_MBConv_j`` blocks, ``_ConvBNAct_1`` head)."""
    m: dict[str, str] = {}

    def bn(flax_prefix: str, torch_prefix: str) -> None:
        m[f"params/{flax_prefix}/scale"] = f"{torch_prefix}.weight"
        m[f"params/{flax_prefix}/bias"] = f"{torch_prefix}.bias"
        m[f"batch_stats/{flax_prefix}/mean"] = f"{torch_prefix}.running_mean"
        m[f"batch_stats/{flax_prefix}/var"] = f"{torch_prefix}.running_var"

    def convbnact(flax_prefix: str, conv_key: str, bn_key: str) -> None:
        m[f"params/{flax_prefix}/Conv_0/kernel"] = f"{conv_key}.weight"
        bn(f"{flax_prefix}/BatchNorm_0", bn_key)

    convbnact("_ConvBNAct_0", "conv_stem", "bn1")
    fused_i = mb_i = 0
    for s, spec in enumerate(config.stages):
        for i in range(spec.count):
            t = f"blocks.{s}.{i}"
            if spec.block == "fused":
                f = f"_FusedMBConv_{fused_i}"
                fused_i += 1
                if spec.expand == 1:
                    convbnact(f"{f}/_ConvBNAct_0", f"{t}.conv", f"{t}.bn1")
                else:
                    convbnact(f"{f}/_ConvBNAct_0", f"{t}.conv_exp", f"{t}.bn1")
                    convbnact(f"{f}/_ConvBNAct_1", f"{t}.conv_pwl", f"{t}.bn2")
            else:
                f = f"_MBConv_{mb_i}"
                mb_i += 1
                convbnact(f"{f}/_ConvBNAct_0", f"{t}.conv_pw", f"{t}.bn1")
                m[f"params/{f}/Conv_0/kernel"] = f"{t}.conv_dw.weight"
                bn(f"{f}/BatchNorm_0", f"{t}.bn2")
                if spec.se_ratio > 0:
                    m[f"params/{f}/_SE_0/Conv_0/kernel"] = f"{t}.se.conv_reduce.weight"
                    m[f"params/{f}/_SE_0/Conv_0/bias"] = f"{t}.se.conv_reduce.bias"
                    m[f"params/{f}/_SE_0/Conv_1/kernel"] = f"{t}.se.conv_expand.weight"
                    m[f"params/{f}/_SE_0/Conv_1/bias"] = f"{t}.se.conv_expand.bias"
                convbnact(f"{f}/_ConvBNAct_1", f"{t}.conv_pwl", f"{t}.bn3")
    convbnact("_ConvBNAct_1", "conv_head", "bn2")
    return m


def effnet_state_dict_from_flax(
    variables_as_numpy: dict, config: EffNetV2Config = EFFNETV2_L
) -> dict[str, torch.Tensor]:
    """The reference's unfolded EffNetV2 variables (``{'params': ...,
    'batch_stats': ...}`` of numpy arrays) -> an ``EffNetV2`` state dict in
    timm's key layout."""
    return _state_dict_from_flax(variables_as_numpy, effnet_name_map(config))


def _load_torch_state_dict(path: str) -> dict[str, torch.Tensor]:
    """A torch checkpoint file (local or through ``io.storage``) -> its state
    dict on the CPU: ``state_dict`` and ``model`` wrappers unwrapped, the
    wrappers' key prefixes stripped. The JAX package's own msgpack format
    raises ``ValueError``."""
    blob = storage.read_bytes(path)
    if blob.startswith(_FLAX_MAGIC):
        raise ValueError(
            f"{path} is a saguaro_tpu (flax msgpack) checkpoint; the port does not read that "
            "format yet (ROADMAP queue 1 item 4)"
        )
    obj = torch.load(io.BytesIO(blob), map_location="cpu", weights_only=True)
    for key in ("state_dict", "model"):
        if isinstance(obj, dict) and isinstance(obj.get(key), dict):
            obj = obj[key]
    sd = {k: v for k, v in obj.items() if isinstance(v, torch.Tensor)}
    for prefix in _PREFIXES:
        if any(k.startswith(prefix) for k in sd):
            sd = {(k[len(prefix):] if k.startswith(prefix) else k): v for k, v in sd.items()}
    return sd


def load_cellpose_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """A cellpose CPnet file -> a ``CellposeUNet`` state dict (cellpose's
    stored diameters, which are not weights, dropped)."""
    sd = _load_torch_state_dict(path)
    return {k: v for k, v in sd.items() if k not in ("diam_mean", "diam_labels")}


def load_effnet_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """A timm or transformers EfficientNetV2 file -> an ``EffNetV2`` state
    dict in timm's keys (the classifier, which the pooled embedding does not
    use, dropped)."""
    sd = _load_torch_state_dict(path)
    return {k: v for k, v in sd.items() if not k.startswith("classifier.")}
