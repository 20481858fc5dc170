"""The draw that every network's weights start from (``networks/<name>.py``
makes each network's weights from it): one call of a generator on the
device, seeded from the run's seed, split over the tensors in order. The
weights are made by the benchmark and handed to both the program and the
reference as state dicts, never made with the program's code."""

from __future__ import annotations

import torch


@torch.no_grad()
def draw_normal(tensors: list, seed: int, device, scale) -> None:
    """Fills each of ``tensors`` in place with ``scale(draw, tensor)``, where
    ``draw`` is its slice, shaped like it, of one standard normal draw of
    their total size, made in one call of a generator on ``device`` seeded
    with ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    flat = torch.randn(sum(t.numel() for t in tensors), generator=gen, device=device)
    off = 0
    for t in tensors:
        t.copy_(scale(flat[off : off + t.numel()].view_as(t), t))
        off += t.numel()
