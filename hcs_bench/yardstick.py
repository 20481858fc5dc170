"""The benchmark's yardstick: the card's published peaks, the least time of
a piece of work, the tiling that a segmenter's FLOPs a site follow, and the
bytes each of the port's hand-written kernels needs for a call (each
network's operation count is in its own module, ``networks/<name>.py``).
Frozen copies of ``chip_smoke.py``'s arithmetic (``bound`` and the byte
counts of ``check_kernels`` and its helpers), so that a change to the
program cannot change how it is measured."""

from __future__ import annotations

from hcs_bench.reference.plain.kernels.segment_cuda import n_lanes_a, n_lanes_c, n_lanes_e

# NVIDIA H100 SXM, the data sheet's dense rates at 700 W
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
PEAKS = {"hbm_bytes_per_s": HBM_BYTES_PER_S, "f32_ops_per_s": F32_OPS_PER_S,
         "bf16_ops_per_s": BF16_OPS_PER_S}


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """Least time on the card (s): the larger of bytes over the memory rate
    and operations over the f32 rate, and which one bounds
    (``chip_smoke.bound``, in seconds)."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def tile_starts(size: int, tile: int, overlap: float) -> list[int]:
    """Tile offsets covering [0, size), cellpose's tiling of the rescaled
    field."""
    if size <= tile:
        return [0]
    stride = max(1, int(tile * (1 - overlap)))
    starts = list(range(0, size - tile + 1, stride))
    if starts[-1] != size - tile:
        starts.append(size - tile)
    return starts


# Bytes and operations of one call of each of the port's kernels, from the
# shapes of its arguments (and, for K1 and K4 radial, a count of the pixels
# whose work it does): each input byte read once, each output byte written
# once, what these inputs need (chip_smoke.check_kernels and its helpers).
# Operations are counted where they follow from shapes alone; elsewhere 0,
# which can only lower a call's least time.

def work_seg_counts(labels, codes, sizes, max_cells, n_labelled) -> tuple[float, float]:
    b, n_q, n = codes.shape
    return 4.0 * b * n + 2.0 * n_labelled * n_q + 4.0 * b * max_cells * sum(sizes), 0.0


def work_seg_take_t(table, seg, max_cells) -> tuple[float, float]:
    b, n = seg.shape
    return 4.0 * b * (max_cells * table.shape[2] + n + table.shape[2] * n), 0.0


def work_seg_sums(labels, values, max_cells) -> tuple[float, float]:
    b, n, k = values.shape
    return (4.0 + 4.0 * k) * b * n + 4.0 * b * max_cells * k, float(b * n * k)


def work_seg_lane_sums_a(labels, image, pweight, border, max_cells, with_edge) -> tuple[float, float]:
    b, n, n_ch = labels.shape[0], labels[0].numel(), image.shape[-1]
    return b * n * (4.0 + 4.0 * n_ch + 4.0 + 1.0) + 4.0 * b * max_cells * n_lanes_a(n_ch, with_edge), 0.0


def work_seg_lane_sums_c(labels, image, border, table, zcoef, max_cells, with_moments, with_zernike,
                         with_edge) -> tuple[float, float]:
    b, n, n_ch = labels.shape[0], labels[0].numel(), image.shape[-1]
    nl = n_lanes_c(n_ch, with_moments, with_zernike, with_edge)
    return b * n * (4.0 + 4.0 * n_ch + 1.0) + 4.0 * b * max_cells * (table.shape[2] + nl), 0.0


def work_seg_lane_sums_e(labels, image, ranks, tff, consts, max_cells) -> tuple[float, float]:
    b, n, n_ch = labels.shape[0], labels[0].numel(), image.shape[-1]
    return b * n * (4.0 + 8.0 * n_ch) + 4.0 * b * max_cells * (n_ch + n_lanes_e(n_ch)), 0.0


def work_seg_radial_sums(labels, codes, image, max_cells, n_codes, n_active) -> tuple[float, float]:
    b, n, n_ch = labels.shape[0], labels[0].numel(), image.shape[-1]
    return (8.0 * b * n + 4.0 * n_ch * n_active + 4.0 * b * max_cells * n_codes * (1 + n_ch),
            n_active * (1.0 + n_ch))


def work_seg_edt_sweep(v2, d2_init, max_radius) -> tuple[float, float]:
    return 12.0 * v2.numel(), 0.0


def work_seg_pick2(hi, lo, tables) -> tuple[float, float]:
    b, n, n_ch = hi.shape
    return b * n * n_ch * (8.0 + 4.0 * tables.shape[4]) + 4.0 * tables.numel(), 0.0


WORK = {name[len("work_"):]: fn for name, fn in globals().items() if name.startswith("work_seg_")}
