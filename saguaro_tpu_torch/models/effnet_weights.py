"""EfficientNetV2 checkpoints: a timm state dict -> an ``EffNetV2`` state dict
(port of ``saguaro_tpu/models/effnet_weights.py``), and the name map between
timm's keys and the JAX package's flax tree.

``EffNetV2`` carries timm's own keys (``tf_efficientnetv2`` naming), so
"converting" a timm or transformers file here means unwrapping it: wrappers
and their key prefixes go (transformers' ``TimmWrapperModel`` stores the
keys under ``timm_model.``), and so does the classifier, which the pooled
embedding does not use. The name map serves the flax side: the JAX
package's variables bridged onto this network
(``effnet_state_dict_from_flax``) and its checkpoint format
(``models/checkpoint.py``).

timm key anatomy:
  conv_stem / bn1                          stem
  blocks.{s}.{i}.conv + bn1                stage-0 fused, expand=1 (ConvBnAct)
  blocks.{s}.{i}.conv_exp + bn1, conv_pwl + bn2   fused, expand>1 (EdgeResidual)
  blocks.{s}.{i}.conv_pw + bn1, conv_dw + bn2,
                 se.conv_reduce/.conv_expand,
                 conv_pwl + bn3            MBConv (InvertedResidual)
  conv_head / bn2                          head
"""

from __future__ import annotations

import torch

from saguaro_tpu_torch.models.effnetv2 import EFFNETV2_L, EffNetV2Config
from saguaro_tpu_torch.models.weights import read_torch_state_dict, state_dict_from_flax, strip_prefixes

__all__ = [
    "effnet_name_map",
    "convert_effnet_state_dict",
    "load_torch_effnet",
    "effnet_state_dict_from_flax",
]


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


def convert_effnet_state_dict(state_dict: dict) -> dict[str, torch.Tensor]:
    """A timm (or transformers ``TimmWrapperModel``) state dict (tensors or
    numpy arrays) -> an ``EffNetV2`` state dict in timm's keys: the wrappers'
    key prefixes stripped, the classifier dropped. Loading it into the
    network checks its keys and shapes."""
    return {k: torch.as_tensor(v) for k, v in strip_prefixes(dict(state_dict)).items()
            if not k.startswith("classifier.")}


def load_torch_effnet(path: str) -> dict[str, torch.Tensor]:
    """A timm or transformers EfficientNetV2 FILE (a torch save, local or
    through ``io.storage``) -> an ``EffNetV2`` state dict on the CPU.
    Unpickles tensors only (``weights_only=True``)."""
    return convert_effnet_state_dict(read_torch_state_dict(path))


def effnet_state_dict_from_flax(
    variables_as_numpy: dict, config: EffNetV2Config = EFFNETV2_L
) -> dict[str, torch.Tensor]:
    """The reference's unfolded EffNetV2 variables (``{'params': ...,
    'batch_stats': ...}`` of numpy arrays) -> an ``EffNetV2`` state dict in
    timm's key layout."""
    return state_dict_from_flax(variables_as_numpy, effnet_name_map(config))
