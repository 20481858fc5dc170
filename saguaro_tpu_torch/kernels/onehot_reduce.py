"""Segment-reduction contracts of the measurement stage.

The JAX package computes these as chunked one-hot matmuls, because TPU
scatters serialise (``saguaro_tpu/kernels/onehot_reduce.py``). The port
keeps the contracts and drops the formulation: a CUDA tensor goes to the
hand-written Hopper kernel of ``kernels/segment_cuda`` (K1-K3), a CPU
tensor to the plain PyTorch twin beside it. Dispatch is by the tensor's
device only.

Every function takes a leading site-batch dimension (the JAX functions
run per site under ``vmap``).
"""

from __future__ import annotations

import torch

from saguaro_tpu_torch.kernels import segment_cuda as sc

__all__ = ["onehot_counts", "segment_matmul_sums", "mxu_take", "mxu_take_t"]


def mxu_take_t(table: torch.Tensor, seg: torch.Tensor, max_cells: int) -> torch.Tensor:
    """(B, max_cells, K) table + (B, N) labels -> (B, K, N) per-pixel rows,
    ``table[b, seg[b, i], k]`` exactly. Non-finite entries and entries of
    magnitude >= 3.38e38 (the empty-label min/max sentinel) read as 0, as
    in the reference's one-hot gather, where every row enters the product.
    A (B, max_cells) table is taken as one column. K2 on CUDA."""
    if table.dim() == 2:
        table = table[..., None]
    table = table.float().contiguous()
    seg = seg.to(torch.int32).contiguous()
    if seg.is_cuda:
        return sc.seg_take_t(table, seg, max_cells)
    return sc.take_t_plain(table, seg, max_cells)


def mxu_take(table: torch.Tensor, seg: torch.Tensor, max_cells: int) -> torch.Tensor:
    """Untransposed ``mxu_take_t``: (B, max_cells, K) + (B, N) -> (B, N, K);
    a (B, max_cells) table gives (B, N)."""
    if table.dim() == 2:
        return mxu_take_t(table, seg, max_cells)[:, 0]
    return mxu_take_t(table, seg, max_cells).transpose(1, 2)


def onehot_counts(
    labels: torch.Tensor,
    codes: list[tuple[torch.Tensor, torch.Tensor, int]],
    max_cells: int,
) -> list[torch.Tensor]:
    """Fused per-label histograms.

    labels: (B, N) ints; codes: list of (code (B, N), valid (B, N) bool,
    n_codes). Returns [(B, max_cells, n_codes_i) f32, ...] counting the
    valid pixels per (label, code); labels outside [0, max_cells) and codes
    outside [0, n_codes) count nothing. K1 on CUDA (exact integer counts).
    """
    sizes = tuple(n for _, _, n in codes)
    if any(n > 32768 for n in sizes):
        # the reference stores codes as int16; keep its limit
        raise ValueError(f"onehot_counts code spaces must fit int16 (<= 32768), got {sizes}")
    code_arr = torch.stack(
        [torch.where(v, c.to(torch.int32), -1) for c, v, _ in codes], dim=1
    ).contiguous()
    labels = labels.to(torch.int32).contiguous()
    if labels.is_cuda:
        g = sc.seg_counts(labels, code_arr, sizes, max_cells)
    else:
        g = sc.counts_plain(labels, code_arr, sizes, max_cells)
    outs, off = [], 0
    for n in sizes:
        outs.append(g[..., off : off + n])
        off += n
    return outs


def segment_matmul_sums(
    labels: torch.Tensor, values: torch.Tensor, max_cells: int
) -> torch.Tensor:
    """(B, N) labels + (B, N, K) real values -> (B, max_cells, K) per-label
    sums in f32 (labels outside [0, max_cells) are dropped). K3 on CUDA.

    The reference splits each value into bf16 hi + lo halves for the MXU
    (about 16 mantissa bits per value); these sums keep the full f32 value.
    """
    labels = labels.to(torch.int32).contiguous()
    values = values.float().contiguous()
    if labels.is_cuda:
        return sc.seg_sums(labels, values, max_cells)
    return sc.sums_plain(labels, values, max_cells)
