"""Cellpose-style U-Net training: ground-truth flows from masks, and the
training loop (port of ``saguaro_tpu/models/cellpose_train.py``).

The reference's segmenter is cellpose's pretrained 'nuclei' checkpoint
(Cellpose_GPU_s3fs.py:108), which cannot always be shipped, so the package
can train its own:

* ``masks_to_flows``: ground-truth flows by heat diffusion from each cell's
  centre (the cellpose paper's construction): masked Jacobi sweeps of the
  heat equation inside every mask at once, on the device, with the centre
  pixel as the source; the flows are the normalised gradient of
  log(1 + heat).
* ``train_cellpose``: Adam on ``CellposeUNet`` over (image, flows,
  cellprob) batches, on one device or data-parallel over a mesh
  (``parallel.mesh``): one replica a data device, gradients summed onto
  the first.

``cli/train_segmenter.py`` trains from (image, mask) TIFF pairs and writes
a checkpoint that both packages' engines load.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from saguaro_tpu_torch.device import resolve_device
from saguaro_tpu_torch.kernels.crops import label_centroids
from saguaro_tpu_torch.kernels.flow_ode import _fma
from saguaro_tpu_torch.models.cellpose import CellposeConfig, flow_loss, init_cellpose, train_step
from saguaro_tpu_torch.parallel.mesh import replicate

__all__ = ["masks_to_flows", "train_cellpose", "synthetic_nuclei", "TrainResult"]


def _f32(v: float) -> float:
    """v rounded to f32 (a Python float holding an f32 value)."""
    return float(np.float32(v))


_FIFTH = _f32(0.2)
# XLA's f32 log (Eigen's plog, after Cephes) and log1p (a Cephes rational
# form below sqrt(2) - 1) coefficients
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1, 1.4249322787e-1,
          -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG_Q1, _LOG_Q2 = _f32(-2.12194440e-4), 0.693359375
_LOG1P_DEN = (1.5062909083469192043167e1, 8.3047565967967209469434e1, 2.2176239823732856465394e2,
              3.0909872225312059774938e2, 2.1642788614495947685003e2, 6.0118660497603843919306e1)
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1, 6.5787325942061044846969e0,
              2.9911919328553073277375e1, 6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)


def _consts(values, like: torch.Tensor) -> torch.Tensor:
    """``values`` as f32 0-d tensors on ``like``'s device."""
    return torch.tensor(values, dtype=torch.float32, device=like.device)


def _log_xla(u: torch.Tensor) -> torch.Tensor:
    """XLA's CPU f32 log of u > 0, bit for bit: the mantissa in [sqrt(1/2),
    sqrt(2)) and the exponent, a degree-8 polynomial in fused
    multiply-adds, the exponent's ln 2 in two parts."""
    u = torch.clamp(u, min=_f32(np.finfo(np.float32).tiny))
    bits = u.view(torch.int32)
    e = ((bits >> 23) - 127).float() + 1.0
    x = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)
    below = x < _f32(0.707106781186547524)
    x = (x - 1.0) + torch.where(below, x, 0.0)
    e = torch.where(below, e - 1.0, e)
    x2 = x * x
    x3 = x2 * x
    p = _consts(_LOG_P, x)
    half, q2 = _consts((-0.5, _LOG_Q2), x)
    y = _fma(_fma(x, p[0], p[1]), x, p[2])
    y1 = _fma(_fma(x, p[3], p[4]), x, p[5])
    y2 = _fma(_fma(x, p[6], p[7]), x, p[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, e * _LOG_Q1)
    x = _fma(x2, half, x) + y
    return _fma(e, q2, x)


def _log1p_xla(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU f32 log1p, bit for bit (held against ``jnp.log1p`` in
    tests/test_torch_train.py): the log of the f32 sum 1 + x from
    sqrt(2) - 1 up, a rational form in fused multiply-adds below. The
    heat's flows are the directions of differences of these logs, which an
    ulp turns around where two neighbours' heat is nearly equal."""
    den_c, num_c = _consts(_LOG1P_DEN, x), _consts(_LOG1P_NUM, x)
    den = x + den_c[0]
    for c in den_c[1:]:
        den = _fma(x, den, c)
    num = _fma(x, num_c[0], num_c[1])
    for c in num_c[2:]:
        num = _fma(x, num, c)
    x2 = x * x
    small = x + _fma(x2, _consts(-0.5, x), (x * x2) * (num / den))
    return torch.where(x.abs() < _f32(0.41421356237309504880), small, _log_xla(x + 1.0))


def _same_label_shift(t: torch.Tensor, lab: torch.Tensor, pad_lab: torch.Tensor, dy: int, dx: int):
    """t's neighbour at (y + dy, x + dx) where it carries the same label, t
    itself where it does not (or lies outside the image)."""
    h, w = t.shape
    tp = torch.nn.functional.pad(t, (1, 1, 1, 1))
    ys, xs = slice(1 + dy, 1 + dy + h), slice(1 + dx, 1 + dx + w)
    return torch.where(pad_lab[ys, xs] == lab, tp[ys, xs], t)


@torch.no_grad()
def _heat_flows(labels: torch.Tensor, centers_y: torch.Tensor, centers_x: torch.Tensor,
                n_iters: int) -> torch.Tensor:
    """Diffuse heat from each label's centre pixel inside its mask, n_iters
    sweeps, in f32 and in the reference's order of operations; (2, H, W) normalised gradients of log(1 + heat), zero outside
    the masks."""
    h, w = labels.shape
    dev = labels.device
    inside = labels > 0
    yy = torch.arange(h, device=dev)[:, None]
    xx = torch.arange(w, device=dev)[None, :]
    idx = torch.clamp(labels, 0, centers_y.shape[0] - 1).long()
    source = inside & (yy == centers_y[idx]) & (xx == centers_x[idx])
    lab = labels.to(torch.int32)
    pad_lab = torch.nn.functional.pad(lab, (1, 1, 1, 1), value=-1)

    t = torch.zeros((h, w), dtype=torch.float32, device=dev)
    for _ in range(n_iters):
        up = _same_label_shift(t, lab, pad_lab, -1, 0)
        down = _same_label_shift(t, lab, pad_lab, 1, 0)
        left = _same_label_shift(t, lab, pad_lab, 0, -1)
        right = _same_label_shift(t, lab, pad_lab, 0, 1)
        # XLA compiles the reference's division by 5.0 into a product with
        # the f32 reciprocal, and so does this
        t = (t + up + down + left + right) * _FIFTH
        t = torch.where(source, t + 1.0, t)
        t = torch.where(inside, t, 0.0)
    logt = _log1p_xla(t)
    dy = (_same_label_shift(logt, lab, pad_lab, 1, 0) - _same_label_shift(logt, lab, pad_lab, -1, 0)) / 2.0
    dx = (_same_label_shift(logt, lab, pad_lab, 0, 1) - _same_label_shift(logt, lab, pad_lab, 0, -1)) / 2.0
    norm = torch.sqrt(dy * dy + dx * dx) + 1e-6
    flows = torch.stack([dy / norm, dx / norm])
    return torch.where(inside[None], flows, 0.0)


def masks_to_flows(
    labels: np.ndarray,
    n_iters: int | None = None,
    max_cells: int = 1024,
    device: str | torch.device | None = None,
) -> np.ndarray:
    """Ground-truth flows (2, H, W) pointing 'uphill' toward each cell's
    centre, for an (H, W) label image, computed on ``device`` (CUDA unless
    the caller names one).

    Heat diffuses from the pixel of each mask nearest its centroid; flows
    are the normalised gradient of log(1 + heat), the cellpose paper's
    construction, which handles non-convex cells (unlike the raw direction
    to the centroid). ``n_iters`` defaults to the reference's 2 x the mean
    cell's side + 40."""
    device = resolve_device(device)
    labels = np.asarray(labels, np.int32)
    cy, cx, _ = (a.numpy().copy() for a in label_centroids(torch.from_numpy(labels), max_cells))
    # snap each centroid to the nearest in-mask pixel (centroids of
    # non-convex masks can fall outside)
    for lab in np.unique(labels[labels > 0]):
        if labels[cy[lab], cx[lab]] != lab:
            ys, xs = np.nonzero(labels == lab)
            k = np.argmin((ys - cy[lab]) ** 2 + (xs - cx[lab]) ** 2)
            cy[lab], cx[lab] = ys[k], xs[k]
    if n_iters is None:
        n_iters = 2 * int(np.sqrt((labels > 0).sum() / max(labels.max(), 1))) + 40
    flows = _heat_flows(torch.from_numpy(labels).to(device), torch.from_numpy(cy).to(device),
                        torch.from_numpy(cx).to(device), n_iters)
    return flows.cpu().numpy()


def synthetic_nuclei(
    rng: np.random.Generator,
    size: int = 128,
    n_cells: int = 8,
    radius_range: tuple[int, int] = (8, 14),
    noise: float = 0.05,
):
    """(image (H, W, 2), labels): bright elliptical nuclei over noise; the
    reference's generator, draw for draw."""
    labels = np.zeros((size, size), np.int32)
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    lab = 0
    for _ in range(n_cells):
        r1 = rng.integers(*radius_range)
        r2 = rng.integers(*radius_range)
        cy = rng.integers(r1 + 2, size - r1 - 2)
        cx = rng.integers(r2 + 2, size - r2 - 2)
        m = ((yy - cy) / r1) ** 2 + ((xx - cx) / r2) ** 2 <= 1
        if (labels[m] > 0).any():
            continue
        lab += 1
        labels[m] = lab
    intensity = np.zeros((size, size), np.float32)
    for l in range(1, lab + 1):
        intensity[labels == l] = rng.uniform(0.6, 1.0)
    image = intensity + rng.normal(0, noise, (size, size)).astype(np.float32)
    img2 = np.stack([image, np.zeros_like(image)], axis=-1)
    return img2.astype(np.float32), labels


@dataclass
class TrainResult:
    variables: dict        # the trained CellposeUNet's state dict
    losses: list[float]
    step_seconds: list[float]  # host seconds a step, its loss read back


def train_cellpose(
    images: np.ndarray,
    flow_targets: np.ndarray,
    prob_targets: np.ndarray,
    config: CellposeConfig,
    n_steps: int = 200,
    batch_size: int = 8,
    learning_rate: float = 1e-3,
    seed: int = 0,
    mesh=None,
    device: str | torch.device | None = None,
) -> TrainResult:
    """Train ``init_cellpose(config, seed)`` on (N, H, W, C) images with
    (N, 2, H, W) flow and (N, H, W) cellprob targets, on ``device`` (CUDA
    unless the caller names one).

    Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8) on the
    parameters; the BatchNorm statistics stay fixed, as the reference's. Each
    step draws ``np.random.default_rng(seed).integers(0, N, batch_size)``,
    as the reference does, so both packages see the same batches.

    With a ``mesh`` (``parallel.mesh``) the step is data-parallel, as the
    reference's replicated-parameter step over its mesh: the weights live on
    the first data device (``device`` is then not used) with one replica on
    each other data device, each step's batch is split into contiguous
    shards over the data axis, each replica runs forward and backward on
    its shard with its loss weighted by its share of the batch, the
    gradients are summed onto the first device (so the loss and its
    gradient are the whole batch's mean), one Adam step updates the
    weights, and the replicas copy them back."""
    device = resolve_device(device) if mesh is None else mesh.data_devices[0]
    model = init_cellpose(config, seed=seed, device=device)
    optimizer = torch.optim.Adam(model.parameters(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    imgs = torch.as_tensor(np.asarray(images, np.float32), device=device)
    flows = torch.as_tensor(np.moveaxis(np.asarray(flow_targets, np.float32), 1, -1), device=device)
    probs = torch.as_tensor(np.asarray(prob_targets, np.float32), device=device)
    replicas = replicate(model, mesh) if mesh is not None else None

    rng = np.random.default_rng(seed)
    n = imgs.shape[0]
    losses, step_seconds = [], []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        idx = torch.as_tensor(rng.integers(0, n, batch_size), device=device)
        batch = (imgs[idx], flows[idx], probs[idx])
        if replicas is None:
            loss = train_step(model, optimizer, batch)
        else:
            loss = _data_parallel_step(model, replicas, optimizer, batch)
        losses.append(float(loss))
        step_seconds.append(time.perf_counter() - t0)
    return TrainResult(variables=model.state_dict(), losses=losses, step_seconds=step_seconds)


def _data_parallel_step(model, replicas, optimizer, batch) -> torch.Tensor:
    """One optimiser step of ``model`` (``replicas[0]``) over a batch split
    into one contiguous shard a replica; returns the whole batch's loss."""
    b = batch[0].shape[0]
    shards = [torch.tensor_split(t, len(replicas)) for t in batch]
    optimizer.zero_grad(set_to_none=True)
    params = list(model.parameters())
    total = torch.zeros((), device=params[0].device)
    for r, replica in enumerate(replicas):
        img, tflow, tprob = (s[r] for s in shards)
        if img.shape[0] == 0:
            continue
        dev = next(replica.parameters()).device
        if replica is not model:
            replica.zero_grad(set_to_none=True)
        loss = flow_loss(replica(img.to(dev)), tflow.to(dev), tprob.to(dev)) * (img.shape[0] / b)
        loss.backward()
        total = total + loss.detach().to(total.device)
    for replica in replicas:
        if replica is model:
            continue
        for p, q in zip(params, replica.parameters()):
            if q.grad is None:
                continue
            g = q.grad.to(p.device)
            p.grad = g if p.grad is None else p.grad + g
    optimizer.step()
    with torch.no_grad():
        for replica in replicas:
            if replica is not model:
                for p, q in zip(params, replica.parameters()):
                    q.copy_(p)
    return total
