"""Profile-stage numerics (port of ``saguaro_tpu/ops``): robustize,
feature selection, cosine blocks, squash and hit calling, each on a torch
device."""

from saguaro_tpu_torch.ops.squash import double_sigmoid
from saguaro_tpu_torch.ops.normalize import mad_robustize, normalize_profiles, annotate
from saguaro_tpu_torch.ops.select import feature_select
from saguaro_tpu_torch.ops.cosine import pairwise_cosine, group_cosine_similarity
from saguaro_tpu_torch.ops.induction import induction_scores, hit_calling

__all__ = [
    "double_sigmoid",
    "mad_robustize",
    "normalize_profiles",
    "annotate",
    "feature_select",
    "pairwise_cosine",
    "group_cosine_similarity",
    "induction_scores",
    "hit_calling",
]
