"""XGBoost-JSON tree-ensemble evaluator, the dead-cell classifier (port of
``saguaro_tpu/models/xgb.py``).

Replaces the reference's ``xgb.Booster.load_model(json)`` +
``bst.predict(DMatrix(flat_features))`` (Cellpose_GPU_s3fs.py:114-118,
208-216): every tree is padded into dense (n_trees, n_nodes) tensors on
the device, and every row walks every tree at once, ``max_depth`` gather
steps in all.

Format: the xgboost >= 1.7 JSON model (``learner.gradient_booster.model.
trees``, each with ``left_children/right_children/split_indices/
split_conditions/default_left``; a leaf has ``left_children == -1`` and its
output value in ``split_conditions``). A missing value (NaN) takes the
node's default branch. ``binary:logistic`` models apply a sigmoid to the
summed margins plus the logit of the stored ``base_score``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass

import numpy as np
import torch

from saguaro_tpu_torch.device import resolve_device

__all__ = ["XGBEnsemble"]


@dataclass
class XGBEnsemble:
    left: torch.Tensor          # (T, N) int64, -1 at leaves
    right: torch.Tensor         # (T, N) int64
    feature: torch.Tensor       # (T, N) int64
    threshold: torch.Tensor     # (T, N) float32 (leaf value at leaves)
    default_left: torch.Tensor  # (T, N) bool
    max_depth: int
    base_margin: float
    objective: str = "binary:logistic"

    @classmethod
    def from_json(cls, path_or_str: str, device: str | torch.device | None = None) -> "XGBEnsemble":
        """A model from its JSON text or a path to it (local or through
        ``io.storage``), on ``device`` (CUDA unless the caller names one)."""
        device = resolve_device(device)
        if path_or_str.lstrip().startswith("{"):
            doc = json.loads(path_or_str)
        else:
            from saguaro_tpu_torch.io import storage

            doc = json.loads(storage.read_bytes(path_or_str).decode("utf-8"))
        learner = doc["learner"]
        objective = learner.get("objective", {}).get("name", "binary:logistic")
        base_score = float(learner.get("learner_model_param", {}).get("base_score", 0.5))
        if objective.startswith("binary:logistic"):
            # stored base_score is a probability; margins add to its logit
            base_margin = float(np.log(base_score / (1.0 - base_score)))
        else:
            base_margin = base_score
        trees = learner["gradient_booster"]["model"]["trees"]
        n_nodes = max(len(t["left_children"]) for t in trees)

        def pad(vals, fill, dtype):
            out = np.full((len(trees), n_nodes), fill, dtype)
            for i, v in enumerate(vals):
                out[i, : len(v)] = v
            return torch.as_tensor(out, device=device)

        left = pad([t["left_children"] for t in trees], -1, np.int64)
        right = pad([t["right_children"] for t in trees], -1, np.int64)
        return cls(
            left=left,
            right=right,
            feature=pad([t["split_indices"] for t in trees], 0, np.int64),
            threshold=pad([t["split_conditions"] for t in trees], 0.0, np.float32),
            default_left=pad(
                [t.get("default_left", [1] * len(t["left_children"])) for t in trees], 1, np.int64
            ).bool(),
            max_depth=_max_depth(left.cpu().numpy(), right.cpu().numpy()),
            base_margin=base_margin,
            objective=objective,
        )

    def predict_margin(self, x) -> torch.Tensor:
        """(B, F) -> (B,) f32: the trees' leaf values summed, plus the base
        margin."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.left.device)
        n_trees = self.left.shape[0]
        node = torch.zeros((x.shape[0], n_trees), dtype=torch.int64, device=x.device)
        flat = torch.arange(n_trees, device=x.device) * self.left.shape[1]
        for _ in range(self.max_depth):
            at = node + flat
            val = x.gather(1, self.feature.view(-1)[at])
            go_left = torch.where(torch.isnan(val), self.default_left.view(-1)[at],
                                  val < self.threshold.view(-1)[at])
            lft = self.left.view(-1)[at]
            nxt = torch.where(go_left, lft, self.right.view(-1)[at])
            node = torch.where(lft < 0, node, nxt)  # stay at leaves
        return self.threshold.view(-1)[node + flat].sum(dim=1) + self.base_margin

    def predict(self, x) -> torch.Tensor:
        """Probability for binary:logistic, the margin otherwise, as
        ``Booster.predict``."""
        m = self.predict_margin(x)
        if self.objective.startswith("binary:logistic"):
            return torch.sigmoid(m)
        return m

    def predict_dead(self, x, threshold: float = 0.5) -> torch.Tensor:
        """The reference's dead-cell rule: preds > 0.5
        (Cellpose_GPU_s3fs.py:216)."""
        return self.predict(x) > threshold


def _max_depth(left: np.ndarray, right: np.ndarray) -> int:
    """The longest root-to-leaf path over all trees (the walk's steps)."""
    depth = 0
    for t in range(left.shape[0]):
        stack = [(0, 0)]
        while stack:
            node, d = stack.pop()
            depth = max(depth, d)
            if left[t, node] >= 0:
                stack.append((int(left[t, node]), d + 1))
                stack.append((int(right[t, node]), d + 1))
    return depth
