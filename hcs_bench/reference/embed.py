"""The reference's embedding: each kept cell's centroid and edge rule from
the reference's own labels, masked crops, and the embedder's forward pass
over them (``networks/<name>.forward``: its preprocessing and network)."""

from __future__ import annotations

import numpy as np
import torch

from hcs_bench.reference.plain.kernels.crops import gather_crops, in_bounds, label_centroids


def kept_cells(labels: np.ndarray, max_cells: int, box: int, device) -> list[np.ndarray]:
    """Per site, (n, 3) int64 rows (label, cy, cx) of the cells the edge
    rule keeps, in label order."""
    lab = torch.as_tensor(labels, device=device)
    cy, cx, cnt = label_centroids(lab, max_cells)
    h, w = labels.shape[1:]
    keep = ((cnt > 0) & in_bounds(cy, cx, h, w, box)).cpu().numpy()
    cy, cx = cy.cpu().numpy(), cx.cpu().numpy()
    return [np.stack([np.flatnonzero(k), y[k], x[k]], axis=1).astype(np.int64)
            for k, y, x in zip(keep, cy, cx)]


@torch.no_grad()
def embed(forward, images: np.ndarray, labels: np.ndarray, slots: np.ndarray, box: int, device,
          chunk: int = 32) -> np.ndarray:
    """(k, 5) slots (site, label, channel, cy, cx) -> (k, D) f32
    embeddings, ``chunk`` crops a call of ``forward``."""
    chw = torch.as_tensor(images.astype(np.float32), device=device).permute(0, 3, 1, 2).contiguous()
    lab = torch.as_tensor(labels, device=device)
    idx = torch.as_tensor(slots.T, device=device)
    out = []
    for s in range(0, idx.shape[1], chunk):
        crops = gather_crops(chw, lab, *idx[:, s : s + chunk], box=box)
        out.append(forward(crops).float().cpu())
    return torch.cat(out).numpy()
