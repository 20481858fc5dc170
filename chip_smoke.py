"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels (K1-K7, ``saguaro_tpu_torch/csrc``) from the
checkout, one ``nvcc`` a source in parallel, holds each one against its
plain PyTorch twin at the shapes its path gives it and times both: K1-K6
at the feature-extraction path's (8 sites of 1080 x 1080, 5 channels,
max_cells=512; K1 and K3 at each of their call sites there, with the
inputs one measurement gives them), K7 at the pixel path's (16 raw 2160 x
2160 uint16 fields re-binned to 1080 x 1080, plus f32 input, an
upsampling and an odd non-square case; K5 also on 8 sparse sites, of 4
small objects each). K3, K4 radial, K5, K6 and K7 are also timed bare: their
C calls alone, back to back, with plans, tables and outputs made
beforehand. K5's operations are counted from the steps of dx its inputs
need, whose mean it logs. Then it drives the paths end to end through the user-facing
entry points. Feature extraction: the full-width CPnet segmentation
engine on 8 synthetic uint16 sites, mask recovery on ground-truth flows
(untrained weights find no cells), ``measure_site_batch`` at the
reference's default FeatureConfig (every family on; the CP ring geometry by the min-plus scan centre race, as the reference's). Job grid:
``run_batch_processing`` over 1 plate x 2 timepoints of 16 sites of
1080 x 1080 x 5 cone-shaped nuclei written as LZW TIFFs, with the
full-width engine (``gradient_cpnet``'s CPnet): two batches a job, the
second dispatched before the first is finalized; every nucleus found, no
site failure, a resume that runs nothing; sites/s and the wall time's split
(TIFF read, segment, dispatch, finalize, CSV writing). Profile and hits: the five
profile CLIs (normalize_cp, feature_select_cosine, pycyto_pertime,
concat_cp, induction_hit) on the job's CSVs and on a 384-well x 4
timepoint plate with the job's columns, each held card against CPU, seconds
a stage (the plots are not drawn where matplotlib is absent, which it logs).
TIFF: 16 raw 2160 x 2160 uint16 fields, uncompressed and LZW, decoded by
the native decoder (one after another and on the prefetch pool) and by
PIL, bit-equal, ms/image. Single site:
``SegmentEmbedEngine.segment`` on one site, and Euler ``compute_masks`` on
a site's ground-truth flows, held against the ground truth and against
the CPU. Pixel stages: ``run_max_projection``, ``run_rebin``, the
``estimate_illum`` CLI and ``run_illumination_qc`` on a temporary plate of
raw 2160 x 2160 uint16 z-stacks (4 fields x 5 channels x 3 planes). Embed:
``embed_sites_pooled`` at the engine's defaults (EfficientNetV2-L in bf16
at 480², crops of 200², chunks of 128) on the 8 sites with their
ground-truth labels, every site's cells and centroids checked against
numpy, timed beside its bound and peak memory, the network held card
against CPU in f32 and bf16 against f32, one chunk timed in NCHW and
channels_last; then the segment-embed CLI (``run_pipeline``) on a 2-site
plate, its four files checked. Training: a small CPnet trained 5 f32 steps
on the card and on the CPU from the same weights, losses held; then the
``train_segmenter`` CLI at its full-width defaults (500 steps of 8 tiles
of 224², bf16) on 32 TIFF pairs of ``synthetic_nuclei``, s/step, images/s,
the bf16-peak share of its convolutions, peak memory and the flows'
seconds; its checkpoint, loaded by the full-width engine, segments 4
held-out tiles and a 1080² field (``segment_batch``), s/site and matched
IoU; the loss must halve and the IoU exceed 0.5. Fine Costes: the main
path's batch measured again at the default FeatureConfig and with
``costes_fine_scale=65535`` (s/site of each, peak memory, launches; K3 must
run at ``costes_fine_refine``, every Costes column finite), the nuclei's
fine thresholds inside the walk's window below the coarse bracket's top,
card against CPU on 128² corners (within 2 fine steps; where equal, C1/C2
within SUM_RTOL), and K3 at the fine shape held and timed into the kernel
line. Oracles: ``moments_features`` and the three ``multichannel_*``
functions on the card against the fused measurement's columns. Family
API: the reference's per-family functions (``segment_stats``,
``intensity_features``, ``shape_features``, ``correlation_features``,
``zernike_features``, ``object_glcm`` and its scatter form, the one-channel
quantile, Edge and radial forms, ``dense_rank_images``,
``otsu_threshold``, ``radial_power_spectrum``, ``segment_tiles``) on the 8
sites, each run alone with its K1, K2, K3 and K6 launches counted; held
against the fused measurement's columns (and the measurement's texture
and quantiles), card against CPU on 128² corners with the min-plus centre
race's ring/wedge codes exactly, and each kernel at each function's first
inputs held and timed into the kernel line as ``<kernel>[<function>]``.
The legacy ``granularity_spectrum`` of a 1080² site, card against CPU. Mesh: a 2-way
mesh of the one card (``make_mesh(devices=[cuda:0, cuda:0])``) shards
``segment_batch`` of 8 and 7 cone sites (labels equal to unsharded), the
measurement of the 8 sites (against the main path's tables; K1-K6
launched) and of 7 (unsharded), the pooled embed of 2 sites and 3 f32
training steps, each against its unsharded run. It
fails unless each path launched every kernel it runs (K1's and K3's
launches are logged by call site, with each site's shape), and prints one
JSON line of per-kernel numbers, the card's name and power limit, and
last ``{"ok": true, "device": {...}}``. Before that it logs the build's
seconds, the compiler's registers, spills and shared memory of K1, K3, K5,
K6, K7 and every K4 kernel (it fails if one spills), their resident blocks
a SM and the K1, K3, K4 radial, K5, K6 and K7 plans at each shape, and it
holds K4 passes A, C
and E against their plain forms on small adversarial sites
(``tests/torch_data.adversarial_lane_sites``): every lane group, 1, 5 and
8 channels (E: 2, 5 and 8), max_cells 16 and 1024. Without a CUDA device,
or without the package beside it, it exits non-zero and prints no
result.

    python3 chip_smoke.py --profile

also runs each stage once more, warmed up, under torch.profiler and logs
its device-busy share (and the job grid's, one job more into another
output directory), the ops with the most device time and, for measure,
the host and device time of each family's ``measure/<family>`` range, the
port's kernels' share of it apart (it fails unless every one of the port's
kernels lies inside a range); and the pixel path once more, with its
device-busy share of the stages' wall time.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

SIZE = 1080
N_SITES = 8
CHANNELS = ("DNA", "GFP", "ER", "Mito", "AGP")
MAX_CELLS = 512
RAW = 2160        # raw field side, re-binned to RAW // 2 (BASELINE.md:22)
PIX_BATCH = 16    # the re-binning and projection drivers' default batch
PIX_FIELDS = 4
PIX_PLANES = 3
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_OPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
BF16_OPS_PER_S = 989e12     # H100 SXM bf16, dense tensor cores
PALLAS = "saguaro_tpu/kernels/segment_pallas.py"
# K4 tolerance: the kernel builds its lanes in f32 and sums them with f32
# atomics in a run-dependent order; against the plain form evaluated in f64
# each sum may be off by a few dozen ulps of its rounding scale (the
# per-label sum of |lane|, and for the Zernike lanes of the radial terms'
# magnitudes, see segment_cuda._lanes_c). Count lanes are exact. The
# radial sums (K4 radial) and pass E are held the same way.
SUM_RTOL = 1e-5
K3_ORDER_MARGIN = 10.0      # K3's f32 sums of many values: x sqrt(count) * 2**-24 (hold_k3_site)
BOX = 200                   # the embed stage's crop box (Cellpose_GPU_s3fs.py:30)
EMBED_SIZE = 480            # its network input
# the (sites x max_cells x box² x channels) f32 crop pool the embed stage
# never holds
POOL_BYTES = N_SITES * MAX_CELLS * BOX * BOX * len(CHANNELS) * 4
# embed numerics (tools/embed_numerics_cpu.py measures these on the CPU):
# the card against the CPU in f32 (TF32 off) differs by summation order
# only, which 79 blocks amplify (a 1e-6 input perturbation grows about
# 190x through L). bf16 against f32 rounds at every layer, and the random
# network amplifies that as much: on the CPU the same check gives cosines
# of 0.946-0.959 between a crop's bf16 and f32 embeddings, where two crops'
# f32 embeddings lie at 0.90-0.93 (their common part dominates). So bf16 is held to keep each crop's identity: a
# crop's bf16 embedding nearer (in cosine) to its own f32 embedding than
# any two crops' f32 embeddings are to each other.
CPU_CHECK_SIZE = 128
EMBED_CPU_RTOL = 1e-3
# objects a well of the profile phase's 384-well plate: a cut from the 256
# nuclei a site of the job grid. The profile stages read and write every
# object row as CSV text on the host; at 256 a well the plate's 12 object
# tables would hold about 14 GB of CSV, which the chain (on the card and
# again on the CPU) could not read, concatenate and write inside the
# script's time limit
PLATE_CELLS = 16
# segmentation's objects a grid site beyond those placed, at most (1 %)
GRID_EXTRA_SHARE = 0.01


def log(msg: str) -> None:
    print(f"[chip_smoke {time.strftime('%H:%M:%S')}] {msg}", flush=True)


def synthetic_sites(n_sites: int, size: int, seed: int):
    """(images (B, size, size, 5) uint16, nuclei (B, size, size) int32):
    a 16 x 16 grid (at 1080^2) of jittered nuclei of radius ~20 inside
    cell bodies of radius ~28. Channel 0 is bright on the nuclei, the
    others on the cell bodies, with per-cell levels and pixel noise."""
    rng = np.random.default_rng(seed)
    n_ch = len(CHANNELS)
    images = rng.integers(80, 120, (n_sites, size, size, n_ch)).astype(np.uint16)
    labels = np.zeros((n_sites, size, size), np.int32)
    yy, xx = np.mgrid[-32:33, -32:33]
    for s in range(n_sites):
        k = 0
        for cy in range(60, size - 20, 64):
            for cx in range(60, size - 20, 64):
                k += 1
                y, x = cy + rng.integers(-3, 4), cx + rng.integers(-3, 4)
                r_n, r_c = rng.uniform(17, 21), rng.uniform(26, 30)
                d2 = yy**2 + xx**2
                win = (slice(y - 32, y + 33), slice(x - 32, x + 33))
                nuc = d2 <= r_n**2
                cell = d2 <= r_c**2
                labels[s][win][nuc] = k
                img = images[s][win]
                img[cell, 1:] += rng.integers(250, 400, n_ch - 1).astype(np.uint16)
                img[nuc, 0] += np.uint16(rng.integers(1500, 2500))
                img[nuc] += rng.integers(0, 200, (int(nuc.sum()), n_ch)).astype(np.uint16)
    return images, labels


def sparse_sites(n_sites: int, size: int, seed: int):
    """(B, size, size) int32 labels of sparse sites, as empty or failed
    wells give them: 4 small round objects (radius 4-9) at seeded places
    on an otherwise empty field, so that most rows hold one label."""
    rng = np.random.default_rng(seed)
    labels = np.zeros((n_sites, size, size), np.int32)
    yy, xx = np.mgrid[:size, :size]
    for s in range(n_sites):
        for k in range(1, 5):
            cy, cx = rng.integers(20, size - 20, 2)
            labels[s][(yy - cy) ** 2 + (xx - cx) ** 2 <= rng.uniform(4, 9) ** 2] = k
    return labels


def time_ms(fn, reps: int) -> float:
    """Median of ``reps`` CUDA-event timings after two warm-up calls."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def time_launches_ms(fn, launches: int = 10, reps: int = 20) -> float:
    """Median over ``reps`` CUDA-event timings of ``launches`` back-to-back
    calls, divided by ``launches``, after two warm-up calls: a launch's
    device time when its host cost is shorter than the kernel (the bare C
    call, without the wrapper's checks and allocation)."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return float(np.median(times))


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """Least time on the card: the larger of bytes over the memory rate and
    operations over the f32 rate (ms), and which one bounds."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def hold_sums(name, got, want, scale):
    """|got - want| <= SUM_RTOL * scale + 1e-6 elementwise over (B, max_cells,
    lanes); returns the largest absolute difference, or raises naming the
    worst (site, label, lane)."""
    err = (got.double() - want).abs()
    ratio = err / (SUM_RTOL * scale + 1e-6)
    if not bool((ratio <= 1.0).all()):
        worst = int(ratio.argmax())
        s, lab, lane = np.unravel_index(worst, tuple(got.shape))
        raise AssertionError(
            f"{name} differs from the plain form: {int((ratio > 1).sum())} sums out of tolerance, "
            f"worst site {s} label {lab} lane {lane}: kernel {got[s, lab, lane].item()!r} "
            f"plain {want[s, lab, lane].item()!r} scale {scale[s, lab, lane].item()!r}")
    return float(err.max())


def ptxas_report(log_text: str) -> list[dict]:
    """Per kernel of an ``nvcc -Xptxas -v`` log: its (mangled) name,
    registers, stack frame, spill stores and loads, and static shared
    memory in bytes."""
    out, cur = [], None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"name": m.group(1), "registers": 0, "stack": 0, "spill_stores": 0,
                   "spill_loads": 0, "smem": 0}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["stack"], cur["spill_stores"], cur["spill_loads"] = (int(v) for v in m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(smem.group(1)) if smem else 0
    return out


def demangle(names: list[str]) -> list[str]:
    """C++ names through ``c++filt`` where the toolkit's host has it."""
    try:
        res = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True, text=True,
                             check=True)
        return res.stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        return names


def log_resources(build_log: str) -> None:
    """Logs the compiler's report of K1's, K3's, K5's, K6's and K7's kernels
    and of every K4 kernel instantiation (passes A, C and E, the radial
    lanes), K5's and K4 radial's resources at the main path's shapes, K6's
    at each chunk of sets, K3's resident CTAs a SM at the main path's
    tables and the K4 run kernels' at 5 and 8 channels (K7's come with its
    plans); fails if any of them spills."""
    from saguaro_tpu_torch.kernels import segment_cuda as sc

    names = ("sag_lanes", "sag_counts", "sag_sums", "sag_lanczos", "sag_radial", "sag_edt_sweep",
             "sag_pick2")
    rep = [k for k in ptxas_report(build_log) if any(n in k["name"] for n in names)]
    kinds = ("lanes_a", "lanes_c", "counts", "sums", "lanczos", "radial", "edt_sweep", "pick2")
    if not all(any(f"sag_{p}_kernel" in k["name"] for k in rep) for p in kinds):
        raise AssertionError("the build log has no ptxas report of the K1, K3, K4 A/C/radial, K5, "
                             "K6 or K7 kernels")
    spilled = []
    for k, name in zip(rep, demangle([k["name"] for k in rep])):
        log(f"ptxas {name}: {k['registers']} registers, {k['spill_stores']} B spill stores, "
            f"{k['spill_loads']} B spill loads, {k['stack']} B stack, {k['smem']} B static smem")
        if k["spill_stores"] + k["spill_loads"] > 0:
            spilled.append(name)
    if spilled:
        raise AssertionError(f"K1, K3, K4 pass A/C/E/radial, K5, K6 or K7 kernels spill "
                             f"registers: {spilled}")
    for vec in (True, False):
        log(f"K5 at rows of {SIZE}, radius 64, {'16' if vec else '4'}-byte form: "
            + json.dumps(sc.edt_kernel_info(SIZE, 64, vec)))
    for n_ch in (1, 5, 8):
        log(f"K4 radial n_ch={n_ch}: " + json.dumps(sc.radial_kernel_info(n_ch)))
    for kc in range(1, sc.K6_MAX_KC + 1):
        log(f"K6 {kc} sets a launch: " + json.dumps(sc.pick2_kernel_info(kc)))
    for width in (1, 2):
        log(f"K3 width {width}, max_cells {MAX_CELLS}: "
            + json.dumps(sc.sums_kernel_info(width, MAX_CELLS)))
    for n_ch in (5, 8):
        for edge in (False, True):
            log(f"K4 A edge={edge} n_ch={n_ch}: "
                + json.dumps(sc.lanes_kernel_info("A", n_ch, (False, False, edge))))
        for flags in itertools.product([False, True], repeat=3):
            log(f"K4 C flags (moments, zernike, edge)={flags} n_ch={n_ch}: "
                + json.dumps(sc.lanes_kernel_info("C", n_ch, flags)))
        log(f"K4 E n_ch={n_ch}: " + json.dumps(sc.lanes_kernel_info("E", n_ch)))


def check_lane_adversarial(dev) -> float:
    """K4 passes A, C and E on small adversarial sites against their f64
    plain forms (SUM_RTOL of each sum's rounding scale; pass A's areas
    exactly): pass A with and without edge lanes and every (moments,
    zernike, edge) combination of C at 1, 5 and 8 channels, pass E at 2, 5
    and 8, each at max_cells 16 and 1024. Returns the largest difference."""
    import torch

    from saguaro_tpu_torch.kernels import segment_cuda as sc
    from saguaro_tpu_torch.kernels.zernike import _radial_coeffs
    from tests.torch_data import (
        adversarial_lane_args_a,
        adversarial_lane_args_c,
        adversarial_lane_args_e,
    )

    worst, n = 0.0, 0
    for n_ch, mc, edge in itertools.product((1, 5, 8), (16, 1024), (False, True)):
        host = adversarial_lane_args_a(n_ch, mc, edge, seed=n_ch + mc)
        args = [torch.as_tensor(a, device=dev) for a in host[:4]] + list(host[4:])
        got = sc.seg_lane_sums_a(*args)
        want = sc.lane_sums_a_plain(*args, dtype=torch.float64)
        worst = max(worst, hold_sums(f"K4 pass A adversarial n_ch={n_ch} mc={mc} edge={edge}", got,
                                     want, sc.lane_sums_a_plain(*args, magnitude=True,
                                                                dtype=torch.float64)))
        if not torch.equal(got[..., 0].double(), want[..., 0]):
            raise AssertionError(f"K4 pass A adversarial n_ch={n_ch} mc={mc}: areas differ")
        n += 1
    for n_ch, mc in itertools.product((1, 5, 8), (16, 1024)):
        for flags in itertools.product([False, True], repeat=3):
            host = adversarial_lane_args_c(n_ch, mc, *flags, _radial_coeffs(), seed=n_ch + mc)
            args = [torch.as_tensor(a, device=dev) for a in host[:5]] + list(host[5:])
            got = sc.seg_lane_sums_c(*args)
            worst = max(worst, hold_sums(f"K4 pass C adversarial n_ch={n_ch} mc={mc} {flags}", got,
                                         sc.lane_sums_c_plain(*args, dtype=torch.float64),
                                         sc.lane_sums_c_plain(*args, magnitude=True,
                                                              dtype=torch.float64)))
            n += 1
    for n_ch, mc in itertools.product((2, 5, 8), (16, 1024)):
        host = adversarial_lane_args_e(n_ch, mc, seed=7 * n_ch + mc)
        args = [torch.as_tensor(a, device=dev) for a in host[:5]] + [mc]
        got = sc.seg_lane_sums_e(*args)
        worst = max(worst, hold_sums(f"K4 pass E adversarial n_ch={n_ch} mc={mc}", got,
                                     sc.lane_sums_e_plain(*args, dtype=torch.float64),
                                     sc.lane_sums_e_plain(*args, magnitude=True,
                                                          dtype=torch.float64)))
        n += 1
    log(f"K4 A/C/E adversarial: {n} cases within tolerance, largest difference {worst:.3g}")
    return worst


def check_kernels(images, labels, dev):
    """Each kernel against its plain form on the main path's inputs; returns
    ({kernel: entry} with error, times and bound, {kernel: counter}, and
    the function that adds an entry, for phases after the main path)."""
    import torch

    from saguaro_tpu_torch.kernels import segment_cuda as sc
    from saguaro_tpu_torch.kernels.segment_reduce import perimeter_weight_image
    from saguaro_tpu_torch.kernels.zernike import _radial_coeffs
    from saguaro_tpu_torch.pipeline.features import measure_site_batch

    b, h, w, n_ch = images.shape
    n = h * w
    img = torch.as_tensor(images.astype(np.float32), device=dev)
    lab = torch.as_tensor(labels, device=dev)
    out, counters = {}, {}

    def entry(name, source, replaces, err, fn, plain, n_bytes, n_ops, library=None, reps=10,
              counter=None, site=None, bare=None):
        counters[name] = (counter or name) if site is None else (counter, site)
        t_b, by = bound(n_bytes, n_ops)
        out[name] = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": 0, "max_abs_err": float(err),
            "ms": time_ms(fn, reps), "plain_ms": time_ms(plain, 3),
            "bound_ms": t_b, "bound_by": by,
            "library_ms": None if library is None else time_ms(library, reps),
        }
        e = out[name]
        if bare is not None:  # the C call alone, launches back to back
            e["bare_ms"] = time_launches_ms(bare)
        log(f"{name}: err {e['max_abs_err']:.3g} kernel {e['ms']:.3f} ms (bare {e.get('bare_ms')}) "
            f"plain {e['plain_ms']:.3f} ms bound {e['bound_ms']:.3f} ms ({by}) "
            f"library {e['library_ms']}")

    # K1 and K3 at every shape the measurement gives them
    with K1Sites(keep=True) as k1_rec, K3Sites(keep=True) as k3_rec:
        measure_site_batch(images, labels, feature_config(), device=dev)
    torch.cuda.synchronize()
    check_counts_shapes(k1_rec, dev, entry)
    del k1_rec

    # K2: centroid + channel-max table gather, with empty-label sentinels
    flat = lab.reshape(b, n)
    seg = torch.where((flat > 0) & (flat < MAX_CELLS), flat, torch.zeros_like(flat)).contiguous()
    rng = np.random.default_rng(1)
    table = rng.uniform(0, 3000, (b, MAX_CELLS, 2 + n_ch)).astype(np.float32)
    table[:, 300:, 2:] = -np.inf  # absent labels: the segment-max identity
    table[:, 0, 2:] = -3.4e38
    tab = torch.as_tensor(table, device=dev)
    hold_k2_site("seg_take_t", tab, seg, MAX_CELLS, dev, entry)

    # K3 at both of its call sites
    check_sums_shapes(k3_rec, dev, entry)
    del k3_rec

    # K4: pass A and pass C lane scans over the nuclei
    pw, border = perimeter_weight_image(lab)
    pw, bnd = pw.contiguous(), border.to(torch.uint8).contiguous()
    n_active = float((lab > 0).sum())
    args_a = (lab, img, pw, bnd, MAX_CELLS, True)
    got = sc.seg_lane_sums_a(*args_a)
    want = sc.lane_sums_a_plain(*args_a, dtype=torch.float64)
    err_a = hold_sums("K4 pass A", got, want, sc.lane_sums_a_plain(*args_a, magnitude=True,
                                                                    dtype=torch.float64))
    if not torch.equal(got[..., 0].double(), want[..., 0]):
        raise AssertionError("K4 pass A areas differ from the plain form")
    want = want.float()
    nl_a = sc.n_lanes_a(n_ch, True)
    entry("seg_lane_sums[A]", "saguaro_tpu_torch/csrc/lane_sums.cu", f"{PALLAS}:608",
          err_a, lambda: sc.seg_lane_sums_a(*args_a), lambda: sc.lane_sums_a_plain(*args_a),
          n_bytes=b * n * (4.0 + 4.0 * n_ch + 4.0 + 1.0) + 4.0 * b * MAX_CELLS * nl_a,
          n_ops=n_active * 2 * nl_a, counter="seg_lane_sums_a")

    cnt = want[..., 0].clamp(min=1.0)
    cy, cx = want[..., 1] / cnt, want[..., 2] / cnt
    mean = want[..., 5 : 5 + n_ch] / cnt[..., None]
    edge_mean = want[..., 5 + 3 * n_ch : 5 + 4 * n_ch] / want[..., 3:4].clamp(min=1.0)
    table_c = torch.cat([cy[..., None], cx[..., None], (cy - 20)[..., None], (cx - 20)[..., None],
                         torch.full_like(cy, 21.0)[..., None], mean, edge_mean], dim=-1).contiguous()
    zc = torch.tensor(_radial_coeffs(), dtype=torch.float32, device=dev)
    args_c = (lab, img, bnd, table_c, zc, MAX_CELLS, True, True, True)
    got = sc.seg_lane_sums_c(*args_c)
    err_c = hold_sums("K4 pass C", got, sc.lane_sums_c_plain(*args_c, dtype=torch.float64),
                      sc.lane_sums_c_plain(*args_c, magnitude=True, dtype=torch.float64))
    nl_c = sc.n_lanes_c(n_ch, True, True, True)
    # per active pixel: build + sum of each lane, the 30 x 10 Zernike radial
    # products (multiply + add), the cos/sin recurrence
    ops_c = n_active * (2 * nl_c + 2 * 300 + 40)
    entry("seg_lane_sums[C]", "saguaro_tpu_torch/csrc/lane_sums.cu", f"{PALLAS}:608",
          err_c, lambda: sc.seg_lane_sums_c(*args_c), lambda: sc.lane_sums_c_plain(*args_c),
          n_bytes=b * n * (4.0 + 4.0 * n_ch + 1.0) + 4.0 * b * MAX_CELLS * (table_c.shape[2] + nl_c),
          n_ops=ops_c, counter="seg_lane_sums_c")
    del want, got, pw, bnd

    check_family_kernels(img, lab, seg, entry, out)
    del img, lab, seg
    check_resample(dev, entry)
    return out, counters, entry


def check_family_kernels(img, lab, seg, entry, entries):
    """K5, K4 radial, K6 and K4 pass E on the inputs the default
    FeatureConfig's families give them at the main path's shapes: the
    nuclei and, for the rank pick, the three object sets (cells grown 8
    rings over the cell-body channels). K5 also on sparse sites, timed
    bare and through the wrapper; K5 and K4 radial are timed bare beside
    the wrapper. ``entries``: the kernel rows ``entry`` writes, which K5
    and K4 radial add their own numbers to."""
    import torch

    from saguaro_tpu_torch.kernels import colocalization as coloc
    from saguaro_tpu_torch.kernels import segment_cuda as sc
    from saguaro_tpu_torch.kernels.radial import cp_ring_wedge
    from saguaro_tpu_torch.kernels.shape_extra import _edt_sweep_inputs

    b, h, w, n_ch = img.shape
    n = h * w
    dev = img.device
    vr = img.reshape(b, n, n_ch).contiguous()
    site = torch.arange(b, device=dev)[:, None]
    big = 3.4e38
    idx = seg.long()[..., None].expand(b, n, n_ch)
    vmax = torch.full((b, MAX_CELLS, n_ch), -big, device=dev).scatter_reduce_(1, idx, vr, "amax")

    # K5: the EDT sweep of the nuclei at the default max_radius, and of
    # sparse sites (empty or failed wells: most rows hold one label)
    radius = 64
    sparse = torch.as_tensor(sparse_sites(b, h, seed=3), device=dev)
    steps = {}
    for name, labels in (("sparse", sparse), ("nuclei", lab)):
        v2, d2 = (t.contiguous() for t in _edt_sweep_inputs(labels))
        got = sc.seg_edt_sweep(v2, d2, radius)
        torch.cuda.synchronize()
        if not torch.equal(got, sc.edt_sweep_plain(v2, d2, radius)):
            raise AssertionError(f"K5 EDT sweep of the {name} sites differs from the plain form")
        steps[name] = edt_steps(got, radius)
        log(f"K5 {name} {(b, h, w)}, R {radius}: equal to the plain form; the inputs need "
            f"{float(steps[name].mean()):.3f} steps of dx a pixel on average (of {radius})")
        if name == "sparse":
            call, _ = edt_bare(v2, d2, radius)
            sparse_ms = {"sparse_bare_ms": time_launches_ms(call),
                         "sparse_ms": time_ms(lambda: sc.seg_edt_sweep(v2, d2, radius), 10)}
            log(f"K5 sparse: bare {sparse_ms['sparse_bare_ms']:.4f} ms, wrapper "
                f"{sparse_ms['sparse_ms']:.4f} ms")
    del sparse
    # per pixel: read v2 and d2, write one float; each step of dx these
    # inputs need is a min, an add and a min
    entry("seg_edt_sweep", "saguaro_tpu_torch/csrc/edt_sweep.cu", f"{PALLAS}:728", 0.0,
          lambda: sc.seg_edt_sweep(v2, d2, radius), lambda: sc.edt_sweep_plain(v2, d2, radius),
          n_bytes=12.0 * b * n, n_ops=3.0 * float(steps["nuclei"].sum()),
          bare=edt_bare(v2, d2, radius)[0])
    entries["seg_edt_sweep"].update(sparse_ms, mean_steps=float(steps["nuclei"].mean()),
                                    sparse_mean_steps=float(steps["sparse"].mean()))
    del v2, d2, got, steps

    # K4 radial: the nuclei's CP ring/wedge codes (4 rings x 8 wedges)
    flat = lab.reshape(b, n).contiguous()
    n_codes = 32
    rw = cp_ring_wedge(lab, MAX_CELLS, 4, radius).reshape(b, n).to(torch.int32).contiguous()
    args_r = (flat, rw, vr, MAX_CELLS, n_codes)
    got = sc.seg_radial_sums(*args_r)
    want = sc.radial_sums_plain(*args_r, dtype=torch.float64)
    if not torch.equal(got[..., 0].double(), want[..., 0]):
        raise AssertionError("K4 radial pixel counts differ from the plain form")
    # the values are non-negative: each sum is its own rounding scale
    err_r = hold_sums("K4 radial", got.reshape(b, MAX_CELLS, -1), want.reshape(b, MAX_CELLS, -1),
                      want.abs().reshape(b, MAX_CELLS, -1))
    raw, code = flat.long(), rw.long()
    act = (raw > 0) & (code >= 0) & (code < n_codes)
    r_size = b * MAX_CELLS * n_codes
    r_key = torch.where(act, site * (MAX_CELLS * n_codes)
                        + torch.where(raw < MAX_CELLS, raw, 0) * n_codes + code, r_size).reshape(-1)
    r_vals = torch.cat([torch.ones((b, n, 1), device=dev), vr], dim=2).reshape(b * n, 1 + n_ch)
    r_acc = torch.zeros((r_size + 1, 1 + n_ch), device=dev)
    # runs: active pixels whose key differs from the previous pixel's
    r_flat = r_key.view(b, n)
    runs = int((act & torch.cat([torch.ones_like(act[:, :1]), r_flat[:, 1:] != r_flat[:, :-1]],
                                dim=1)).sum())
    log(f"K4 radial: {float(act.float().mean()):.4f} of the pixels in a bin, {runs} runs of "
        f"equal (label, bin) keys, {runs / b:.0f} a site")
    # the bytes these inputs need: every label and code, the values of the
    # pixels in a bin, the table written once
    entry("seg_radial_sums", "saguaro_tpu_torch/csrc/radial_sums.cu", f"{PALLAS}:608", err_r,
          lambda: sc.seg_radial_sums(*args_r), lambda: sc.radial_sums_plain(*args_r),
          n_bytes=8.0 * b * n + 4.0 * n_ch * float(act.sum()) + 4.0 * r_size * (1 + n_ch),
          n_ops=float(act.sum()) * (1 + n_ch),
          library=lambda: r_acc.index_add_(0, r_key, r_vals),
          bare=radial_bare(*args_r)[0])
    entries["seg_radial_sums"]["runs"] = runs
    del got, want, rw, r_key, r_vals, r_acc, act, raw, code, r_flat

    # K6: dense-rank tables of the three object sets, as colocalization
    # builds them
    hi, lo, tables, flats, insides, norm, n_distinct = rank_pick_inputs(img, lab)
    ranks_all = sc.seg_pick2(hi, lo, tables)
    torch.cuda.synchronize()
    if not torch.equal(ranks_all, sc.pick2_plain(hi, lo, tables)):
        raise AssertionError("K6 rank pick differs from the plain form")
    k_sets = tables.shape[4]
    if not all(ranks_all[..., k].is_contiguous() for k in range(k_sets)):
        raise AssertionError(f"K6's per-set ranks are not contiguous: strides {ranks_all.stride()}")
    call, bare_out = pick2_bare(hi, lo, tables)
    call()
    torch.cuda.synchronize()
    if not torch.equal(bare_out, ranks_all):
        raise AssertionError("K6's bare launch differs from its wrapper")
    hold_k6_site("seg_pick2", hi, lo, tables, dev, entry, bare=call)
    del hi, lo, bare_out, call

    # K4 pass E over the nuclei: their ranks from K6 (the Nuclei set's
    # plane, contiguous: no copy), Manders thresholds at 15 % of each
    # object's channel maximum, Costes thresholds of the descent
    pairs = coloc._pairs(n_ch)
    ranks = ranks_all[..., 1]
    thr_f, thr_s = coloc.costes_thresholds(vr / norm[:, None, None], insides["Nuclei"], pairs)
    nd = n_distinct["Nuclei"]
    inv_r = torch.stack([1.0 / torch.clamp(torch.maximum(nd[a], nd[c]), min=1.0)
                         for a, c in pairs], dim=1)
    tff = (0.15 * torch.where(vmax.abs() < 3.38e38, vmax, torch.zeros_like(vmax))).contiguous()
    consts = torch.stack([thr_f * norm[:, None], thr_s * norm[:, None], inv_r],
                         dim=1).float().contiguous()
    args_e = (flats["Nuclei"], vr, ranks, tff, consts, MAX_CELLS)
    got = sc.seg_lane_sums_e(*args_e)
    err_e = hold_sums("K4 pass E", got, sc.lane_sums_e_plain(*args_e, dtype=torch.float64),
                      sc.lane_sums_e_plain(*args_e, magnitude=True, dtype=torch.float64))
    nl_e = sc.n_lanes_e(n_ch)
    # per labelled pixel: build and add each lane, the rank weight and the
    # threshold tests of each pair
    entry("seg_lane_sums[E]", "saguaro_tpu_torch/csrc/lane_sums.cu", f"{PALLAS}:608", err_e,
          lambda: sc.seg_lane_sums_e(*args_e), lambda: sc.lane_sums_e_plain(*args_e),
          n_bytes=b * n * (4.0 + 8.0 * n_ch) + 4.0 * b * MAX_CELLS * (n_ch + nl_e),
          n_ops=float(insides["Nuclei"].sum()) * (2 * nl_e + 6 * len(pairs) + n_ch),
          counter="seg_lane_sums_e")


def rank_pick_inputs(img, lab):
    """K6's inputs at the main path's shapes, as colocalization builds them
    for the three object sets (cells grown 8 rings over the cell-body
    channels, Cells = Nuclei + Cytoplasm): uint16 codes split into hi and lo
    bytes (B, N, C) int32 and the dense-rank tables (B, C, 256, 256, 3);
    with the sets' flat labels and masks, the codes' normaliser and each
    set's distinct values a channel, which pass E takes."""
    import torch

    from saguaro_tpu_torch.kernels import colocalization as coloc
    from saguaro_tpu_torch.kernels.morphology import expand_labels, tertiary_objects

    b, h, w, n_ch = img.shape
    n = h * w
    vr = img.reshape(b, n, n_ch)
    body = img[..., 1:].mean(dim=-1)
    cells = expand_labels(lab, body, 200.0, iterations=8)
    sets = {"Cells": cells, "Nuclei": lab, "Cytoplasm": tertiary_objects(cells, lab)}
    flats = {k: v.reshape(b, n).to(torch.int32).contiguous() for k, v in sets.items()}
    insides = {k: f > 0 for k, f in flats.items()}
    codes16, norm = coloc._intensity_codes(vr, insides["Cells"] | insides["Nuclei"], True)
    hi, lo = (codes16 >> 8).contiguous(), (codes16 & 0xFF).contiguous()
    cnt = coloc._value_count_tables(hi, lo, [insides["Nuclei"], insides["Cytoplasm"]])
    cnt_by = {"Nuclei": cnt[..., 0], "Cytoplasm": cnt[..., 1]}
    cnt_by["Cells"] = cnt_by["Nuclei"] + cnt_by["Cytoplasm"]
    tabs, n_distinct = [], {}
    for c in range(n_ch):
        per_set = []
        for nm in sets:
            t, nd = coloc._rank_table(cnt_by[nm][:, c])
            per_set.append(t)
            n_distinct.setdefault(nm, []).append(nd)
        tabs.append(torch.stack(per_set, dim=-1))
    tables = torch.stack(tabs, dim=1).contiguous()  # (B, C, 256, 256, 3)
    return hi, lo, tables, flats, insides, norm, n_distinct


# K1's call sites on the main path (file, function) and the names of their
# rows; a site that gives K1 two shapes is told apart by its planes
K1_SITES = {
    ("thresholding.py", "_hist"): "seg_counts",
    ("shape_extra.py", "radius_features"): "seg_counts[radius {}]",
    ("glcm.py", "object_glcm_multichannel"): "seg_counts[texture]",
    ("objects_extra.py", "_two_level_ranks"): "seg_counts[{}]",
    ("objects_extra.py", "neighbor_features"): "seg_counts[{}]",
    ("colocalization.py", "_value_count_tables"): "seg_counts[rank values]",
    ("colocalization.py", "_joint_tables"): "seg_counts[costes joint{}]",
}


class K1Sites:
    """Wraps ``seg_counts`` while active: tallies K1's launches by call site
    (the caller of ``onehot_counts``: file, function, line, max_cells,
    sizes) and, with ``keep``, keeps each site's first inputs."""

    def __init__(self, keep: bool):
        from saguaro_tpu_torch.kernels import segment_cuda as sc

        self.sc, self.keep, self.calls, self.inputs = sc, keep, {}, {}

    def __enter__(self):
        real = self.real = self.sc.seg_counts

        def counted(labels, codes, sizes, max_cells):
            f = sys._getframe(1)
            while f.f_code.co_name != "onehot_counts":
                f = f.f_back
            f = f.f_back
            key = (os.path.basename(f.f_code.co_filename), f.f_code.co_name, f.f_lineno,
                   max_cells, tuple(sizes))
            self.calls[key] = self.calls.get(key, 0) + 1
            if self.keep and key not in self.inputs:
                self.inputs[key] = (labels, codes)
            return real(labels, codes, sizes, max_cells)

        self.sc.seg_counts = counted
        return self

    def __exit__(self, *exc):
        self.sc.seg_counts = self.real

    def names(self) -> dict:
        """Call site -> its row's name in the kernels line."""
        out = {}
        first_rank = min((k[2] for k in self.calls if k[1] == "_two_level_ranks"), default=None)
        for key in self.calls:
            fname, func, line, mc, sizes = key
            fmt = K1_SITES.get((fname, func), f"seg_counts[{fname}:{func}:{line}]")
            if func == "radius_features":
                label = "coarse" if len(sizes) == 1 else "fine"
            elif func == "_two_level_ranks":
                label = ("quantile level 1" if line == first_rank else
                         "quantile levels 2-4" if len(sizes) > len(CHANNELS) else "MAD levels 2-4")
            elif func == "neighbor_features":
                label = "neighbour pairs" if sizes[0] > 1 else "PercentTouching"
            elif func == "_joint_tables":
                label = "" if len(sizes) == 8 else f" {len(sizes)}"
            else:
                label = ""
            out[key] = fmt.format(label)
        return out


def check_counts_shapes(rec, dev, entry):
    """K1 at every shape the main path gives it: each call site's first
    inputs kept from one ``measure_site_batch`` at the default
    FeatureConfig (``rec``, a K1Sites), each held and timed by
    ``hold_k1_site``. Logs each shape's plan and the kernel's resources
    under it."""
    import torch

    from saguaro_tpu_torch.kernels import segment_cuda as sc

    log(f"K1: {sum(rec.calls.values())} launches a batch at {len(rec.calls)} call sites")
    names = rec.names()
    for key, (lab, codes) in rec.inputs.items():
        _, _, _, mc, sizes = key
        name = names[key]
        b, n_q, n = codes.shape
        plan = sc.counts_plan(mc, sizes, b, n, torch.cuda.get_device_properties(dev).multi_processor_count)
        log(f"{name} {key[:3]}: {rec.calls[key]} launches a batch, max_cells {mc}, {n_q} planes "
            f"{sorted(set(sizes))}; plan {plan}; {json.dumps(sc.counts_kernel_info(plan))}")
        hold_k1_site(name, lab, codes, sizes, mc, dev, entry, site=key)


def hold_k1_site(name, lab, codes, sizes, mc, dev, entry, site=None):
    """K1 on one call site's inputs, held exactly against the plain form and
    timed beside one ``torch.bincount`` over every plane's keys, as kernel
    entry ``name`` (with ``site``, counted by K1Sites' call site). The bound
    counts what these inputs need: every label, the codes of the pixels
    whose label lies in [0, max_cells) (``onehot_counts`` gives the pixels
    outside its caller's ``label_valid`` label -1), the table written once,
    and one operation a valid key. Logs the time of ``onehot_counts``'
    label mask (one ``torch.where`` over the labels), which the K1 rows
    leave out."""
    import torch

    from saguaro_tpu_torch.kernels import segment_cuda as sc

    b, n_q, n = codes.shape
    got = sc.seg_counts(lab, codes, sizes, mc)
    torch.cuda.synchronize()
    if not torch.equal(got, sc.counts_plain(lab, codes, sizes, mc)):
        raise AssertionError(f"K1 {name} differs from the plain form")
    del got
    total = sum(sizes)
    size = b * mc * total
    site_i = torch.arange(b, device=dev)[:, None, None]
    offs = torch.tensor(np.cumsum((0,) + tuple(sizes)[:-1]), device=dev)[None, :, None]
    lab_l = lab.long()[:, None, :]
    ok = (codes >= 0) & (lab_l >= 0) & (lab_l < mc)
    keys = torch.where(ok, site_i * (mc * total) + lab_l * total + offs + codes, size).reshape(-1)
    n_keys = float(ok.sum())
    n_labelled = float(((lab >= 0) & (lab < mc)).sum())
    del ok, lab_l
    keep = lab >= 0
    mask_ms = time_ms(lambda: torch.where(keep, lab, -1), 10)
    log(f"{name}: {n_labelled / (b * n):.4f} of the pixels labelled, {n_keys:.0f} valid keys; "
        f"onehot_counts' label mask {mask_ms:.4f} ms")
    entry(name, "saguaro_tpu_torch/csrc/counts.cu", f"{PALLAS}:252", 0.0,
          lambda: sc.seg_counts(lab, codes, sizes, mc),
          lambda: sc.counts_plain(lab, codes, sizes, mc),
          n_bytes=4.0 * b * n + 2.0 * n_labelled * n_q + 4.0 * size, n_ops=n_keys,
          library=lambda: torch.bincount(keys, minlength=size + 1),
          counter="seg_counts" if site is not None else None, site=site)
    del keys, keep


# K3's call sites on the main path (the caller of segment_matmul_sums) and
# the names of their rows
K3_SITES = {"euler_numbers": "seg_sums[euler]", "radius_features": "seg_sums[radius]"}


# the segment_cuda function K3Sites wraps: K3's wrapper on the card (the
# CPU rehearsals wrap its plain form)
K3_WRAPPED = "seg_sums"


class K3Sites:
    """Wraps ``seg_sums`` while active: tallies K3's launches (one a lane
    chunk of a call) by call site (the function that called
    ``segment_matmul_sums``) and, with ``keep``, keeps each site's first
    inputs."""

    def __init__(self, keep: bool):
        from saguaro_tpu_torch.kernels import segment_cuda as sc

        self.sc, self.keep, self.calls, self.inputs = sc, keep, {}, {}
        self.name = K3_WRAPPED

    def __enter__(self):
        real = self.real = getattr(self.sc, self.name)

        def counted(labels, values, max_cells, **kw):
            f = sys._getframe(1)
            while f.f_code.co_name != "segment_matmul_sums":
                f = f.f_back
            site = f.f_back.f_code.co_name
            if self.keep and site not in self.inputs:
                self.inputs[site] = (labels, values, max_cells)
            before = self.sc.LAUNCHES["seg_sums"]
            out = real(labels, values, max_cells, **kw)
            # a call launches once a lane chunk (the plain form: one call)
            n = self.sc.LAUNCHES["seg_sums"] - before
            self.calls[site] = self.calls.get(site, 0) + max(n, 1)
            return out

        setattr(self.sc, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.sc, self.name, self.real)


def sums_bare(labels, values, max_cells):
    """K3's launches as the C calls alone, into one output made beforehand
    (timing only: the sums pile up over the calls)."""
    import torch

    from saguaro_tpu_torch.kernels import segment_cuda as sc

    dev = labels.device
    b, n = labels.shape
    k = values.shape[2]
    plan = sc.sums_card_plan(b, n, k, max_cells, dev)
    out = torch.zeros((b, max_cells, k), dtype=torch.float32, device=dev)
    launches = sc.sums_launches(labels, values, out, plan)
    fn = sc._lib().sag_sums

    def call():
        stream = torch.cuda.current_stream(dev).cuda_stream
        for args, _ in launches:
            if fn(*args, stream) != 0:
                raise RuntimeError("sag_sums failed")

    log(f"K3 plan at {(b, n, k)}, max_cells {max_cells}: {plan}")
    return call


def edt_bare(v2, d2, radius):
    """K5's launch as the C call alone, into an output made beforehand:
    (call, output)."""
    import torch

    from saguaro_tpu_torch.kernels import segment_cuda as sc

    b, h, w = v2.shape
    out = torch.empty_like(v2)
    args = (v2.data_ptr(), d2.data_ptr(), out.data_ptr(), b, h, w, radius)
    fn = sc._lib().sag_edt_sweep
    log(f"K5 geometry at {(b, h, w)}, radius {radius}: {sc.edt_geometry(w, radius)}")

    def call():
        if fn(*args, torch.cuda.current_stream(v2.device).cuda_stream) != 0:
            raise RuntimeError("sag_edt_sweep failed")

    return call, out


def radial_bare(labels, codes, image, max_cells, n_codes):
    """K4 radial's launch as the C call alone, with its plan and a
    zero-filled output made beforehand (timing only: the sums pile up over
    the calls): (call, output)."""
    import torch

    from saguaro_tpu_torch.kernels import segment_cuda as sc

    dev = labels.device
    b, n = labels.shape
    n_ch = image.shape[2]
    plan = sc.radial_card_plan(b, n, n_ch, dev)
    out = torch.zeros((b, max_cells, n_codes, 1 + n_ch), dtype=torch.float32, device=dev)
    args, keep = sc.radial_args(labels, codes, image, out, plan)
    fn = sc._lib().sag_radial_sums
    log(f"K4 radial plan at {(b, n, n_ch)}, max_cells {max_cells}, {n_codes} bins: {plan}")

    def call(keep=keep):
        if fn(*args, torch.cuda.current_stream(dev).cuda_stream) != 0:
            raise RuntimeError("sag_radial_sums failed")

    return call, out


def pick2_bare(hi, lo, tables):
    """K6's launch as the C call alone, with its plan and output made
    beforehand: (call, output in the wrapper's (B, N, C, K) view)."""
    import torch

    from saguaro_tpu_torch.kernels import segment_cuda as sc

    dev = hi.device
    b, n, n_ch = hi.shape
    k = tables.shape[4]
    plan = sc.pick2_plan(b, n, n_ch)
    buf, out = sc.pick2_out(b, n, n_ch, k, dev)
    args, keep = sc.pick2_args(hi, lo, tables, buf, plan)
    fn = sc._lib().sag_pick2
    log(f"K6 plan at {(b, n, n_ch)}, {k} sets: {plan}; "
        + json.dumps(sc.pick2_kernel_info(min(k, sc.K6_MAX_KC))))

    def call(keep=keep):
        if fn(*args, torch.cuda.current_stream(dev).cuda_stream) != 0:
            raise RuntimeError("sag_pick2 failed")

    return call, out


def edt_steps(out, radius):
    """Per pixel, the steps of dx the sweep needs on these inputs: the dx
    in 1..radius with dx^2 < out (all of them where out is NaN)."""
    import torch

    need = torch.ceil(torch.sqrt(out.double().clamp(min=0.0))) - 1.0
    return torch.where(out.isnan(), float(radius), need.clamp(0.0, float(radius)))


def check_sums_shapes(rec, dev, entry):
    """K3 at both of its call sites on the main path, with the inputs one
    ``measure_site_batch`` at the default FeatureConfig gives it (``rec``, a
    K3Sites): the Euler corner streams (small integers) held exactly, the
    radius sums to SUM_RTOL of each label's sum of |value| (the plain form
    in f64), each timed through the wrapper and bare, beside one
    ``index_add_`` (``hold_k3_site``)."""
    if set(rec.inputs) != set(K3_SITES):
        raise AssertionError(f"K3's call sites on the main path: {sorted(rec.inputs)}")
    for site, name in K3_SITES.items():
        hold_k3_site(rec, site, name, dev, entry, exact=site == "euler_numbers")


def hold_k3_site(rec, site, name, dev, entry, exact=False, count_lane=None):
    """K3 at one call site, with the first inputs ``rec`` (a K3Sites) kept
    there: held against the plain form in f64 (exactly, or to SUM_RTOL of
    each label's sum of |value|; with a ``count_lane`` of ones, that lane
    exactly and the others within the larger of SUM_RTOL and
    K3_ORDER_MARGIN * sqrt(count) * 2**-24 of it), timed through the wrapper and bare, beside
    one ``index_add_``, as kernel entry ``name``. The bound: 4 B of label
    and 4 B a value lane a pixel, the table written once, one add a
    value."""
    import torch

    from saguaro_tpu_torch.kernels import segment_cuda as sc

    lab, val, mc = rec.inputs[site]
    b, n, k = val.shape
    got = sc.seg_sums(lab, val, mc)
    want = sc.sums_plain(lab, val, mc, dtype=torch.float64)
    torch.cuda.synchronize()
    if exact:
        if not torch.equal(got.double(), want):  # small integers: exact in any order
            raise AssertionError(f"K3 {site} sums differ from the plain form")
        err = 0.0
    else:
        scale = sc.sums_plain(lab, val.abs(), mc, dtype=torch.float64)
        if count_lane is not None:
            # the count lane is exact (integers below 2**24 in any order);
            # the others within SUM_RTOL, or, where a bin takes many values,
            # K3_ORDER_MARGIN * sqrt(count) * 2**-24 of their sum of |value|:
            # K3 adds a bin's values one at a time into a shared-memory slot
            # in an order that varies, whose rounding errors add up like a
            # random walk (about sqrt(count) * 2**-24 / 3 of the sum for
            # same-signed values), far below the sequential worst case of
            # (count - 1) * 2**-24
            counts = want[..., count_lane:count_lane + 1]
            if not torch.equal(got[..., count_lane].double(), counts[..., 0]):
                raise AssertionError(f"K3 {site} counts differ from the plain form")
            walk = torch.sqrt(counts) * 2.0**-24
            rel = ((got.double() - want).abs() / (walk * scale + 1e-6)).amax()
            scale = scale * torch.clamp(K3_ORDER_MARGIN * walk / SUM_RTOL, min=1.0)
            log(f"{name}: bins of up to {int(counts.max())} values; tolerance of the densest "
                f"{float(torch.clamp(K3_ORDER_MARGIN * walk.max(), min=SUM_RTOL)):.3g} of its sum "
                f"of |value|; worst error {float(rel):.3g} x (sqrt(count) * 2**-24 of a bin's sum "
                f"of |value|, + 1e-6) (limit {K3_ORDER_MARGIN} where that exceeds SUM_RTOL)")
        err = hold_sums(f"K3 {site}", got, want, scale)
    nz = float((val != 0).any(dim=2).sum())
    log(f"{name}: {rec.calls[site]} launches a batch, {(b, n, k)}, max_cells {mc}, "
        f"{nz / (b * n):.4f} of the pixels with a non-zero value")
    flat_idx = torch.where((lab >= 0) & (lab < mc),
                           lab.long() + torch.arange(b, device=dev)[:, None] * mc,
                           b * mc).reshape(-1)
    flat_val = val.reshape(-1, k)
    acc = torch.zeros((b * mc + 1, k), device=dev)
    entry(name, "saguaro_tpu_torch/csrc/sums.cu", f"{PALLAS}:460", err,
          lambda: sc.seg_sums(lab, val, mc), lambda: sc.sums_plain(lab, val, mc),
          n_bytes=(4.0 + 4.0 * k) * b * n + 4.0 * b * mc * k, n_ops=float(b * n * k),
          library=lambda: acc.index_add_(0, flat_idx, flat_val), counter="seg_sums",
          site=site, bare=sums_bare(lab, val, mc))
    del got, want, flat_idx, flat_val, acc


def hold_resample(name, imgs, out_shape):
    """K7 on ``imgs`` against its plain form: the f32 sums to SUM_RTOL of
    each output's sum of |w * x| (the plain form in f64), and for integer
    inputs the results after PIL's rounding within 1 unit. Returns the
    largest difference of the final results (integer units, or f32)."""
    import torch

    from saguaro_tpu_torch.kernels import resample as rs

    got = rs.lanczos_resample(imgs, out_shape)
    want = rs.resize_plain(imgs, out_shape, dtype=torch.float64)
    scale = rs.resize_plain(imgs, out_shape, magnitude=True, dtype=torch.float64)
    err = (got.double() - want).abs()
    ratio = err / (SUM_RTOL * scale + 1e-6)
    if not bool((ratio <= 1.0).all()):
        raise AssertionError(f"K7 {name}: {int((ratio > 1).sum())} sums out of tolerance, "
                             f"worst {float(ratio.max()):.3g} of it")
    if imgs.dtype.is_floating_point:
        diff = float(err.max())
    else:
        final = rs._cast(got, imgs.dtype).to(torch.int32)
        plain = rs._cast(rs.resize_plain(imgs, out_shape), imgs.dtype).to(torch.int32)
        diff = float((final - plain).abs().max())
        if diff > 1:
            raise AssertionError(f"K7 {name}: rounded results differ by {diff} units")
    log(f"K7 {name}: sums within {float(ratio.max()):.3g} of the tolerance, results within "
        f"{diff:.3g} of the plain form's")
    return diff


def lanczos_bare(imgs, out_shape):
    """K7's launch as the C call alone, with the band tables, the plan and
    the output made beforehand."""
    import torch

    from saguaro_tpu_torch.kernels import resample as rs
    from saguaro_tpu_torch.kernels import resample_cuda as rc
    from saguaro_tpu_torch.kernels import segment_cuda as sc

    dev = imgs.device
    (b, in_h, in_w), (h, w) = imgs.shape, out_shape
    plan = rs._card_plan(in_h, in_w, h, w, b, imgs.dtype, dev)
    out = torch.empty((b, h, w), dtype=torch.float32, device=dev)
    args = rc.lanczos_args(imgs, rs._device_bands(in_h, h, dev), rs._device_bands(in_w, w, dev),
                           plan, out)
    fn = sc._lib().sag_lanczos
    info = rc.lanczos_kernel_info(rc._DTYPE_CODES[imgs.dtype], plan.rows, plan.cols)
    log(f"K7 plan at {tuple(imgs.shape)} {imgs.dtype} -> {out_shape}: {plan}; {json.dumps(info)}")

    def call():
        if fn(*args, torch.cuda.current_stream(dev).cuda_stream) != 0:
            raise RuntimeError("sag_lanczos failed")

    return call


def check_resample(dev, entry):
    """K7 at the pixel path's run point (16 raw 2160^2 uint16 fields ->
    1080^2), on f32 input, upsampling uint8 and an odd non-square batch of
    one, each against its plain form and timed bare (the C call alone,
    tables and plan made beforehand); at the run point also through the
    wrapper, beside the dense matmul pair that is the reference's XLA
    contract."""
    import torch

    from saguaro_tpu_torch.kernels import resample as rs

    g = torch.Generator(device=dev).manual_seed(7)

    def raw(shape, high, dtype):
        return torch.randint(0, high, shape, generator=g, device=dev, dtype=torch.int32).to(dtype)

    out = (RAW // 2, RAW // 2)
    imgs = raw((PIX_BATCH, RAW, RAW), 65536, torch.uint16)
    err = hold_resample("16 x 2160^2 uint16 -> 1080^2", imgs, out)
    others = {
        "4 x 2160^2 f32 -> 1080^2": (imgs[:4].float() * 0.37 - 1.0e4, out),
        "2 x 540x720 uint8 -> 1080x1440": (raw((2, 540, 720), 256, torch.uint8), (1080, 1440)),
        "1 x 1001x1537 uint16 -> 433x761": (raw((1, 1001, 1537), 65536, torch.uint16), (433, 761)),
    }
    for name, (x, shape) in others.items():
        hold_resample(name, x, shape)
        log(f"K7 {name}: bare {time_launches_ms(lanczos_bare(x, shape)):.4f} ms, wrapper "
            f"{time_ms(lambda: rs.lanczos_resample(x, shape), 10):.4f} ms")
    del others
    # the separable work: each output row's taps over every input column,
    # then each output's taps along the row (multiply + add each)
    _, ny, _ = rs.axis_windows(RAW, out[0])
    _, nx, _ = rs.axis_windows(RAW, out[1])
    ops = 2.0 * PIX_BATCH * (float(ny.sum()) * RAW + out[0] * float(nx.sum()))
    xf = imgs.float()
    ry, rx = (torch.as_tensor(m, device=dev) for m in rs.lanczos_matrices((RAW, RAW), out))
    entry("lanczos_resize", "saguaro_tpu_torch/csrc/lanczos.cu",
          "saguaro_tpu/kernels/resample_pallas.py:125", err,
          lambda: rs.lanczos_resample(imgs, out), lambda: rs.resize_plain(imgs, out),
          n_bytes=2.0 * PIX_BATCH * RAW * RAW + 4.0 * PIX_BATCH * out[0] * out[1], n_ops=ops,
          library=lambda: torch.matmul(torch.matmul(ry, xf), rx.T), bare=lanczos_bare(imgs, out))


def run_pixel_path(dev, size=RAW, n_fields=PIX_FIELDS, n_planes=PIX_PLANES, seed=11):
    """The pixel stages through their user-facing entry points on a
    temporary plate of raw uint16 z-stacks (n_fields x 5 channels x
    n_planes TIFFs of size^2): ``run_max_projection``, ``run_rebin`` to
    (size/2)^2, the ``estimate_illum`` CLI on the re-binned images and
    ``run_illumination_qc`` with those functions, each at its default
    batch. Checks the projections exactly against ``np.maximum.reduce``, the
    re-binned files' size, dtype and place, the illumination functions and
    every QC column. Returns seconds per image of each stage, host I/O
    included."""
    import pandas as pd

    from saguaro_tpu_torch.cli.estimate_illum import main as estimate_illum
    from saguaro_tpu_torch.io import tiff
    from saguaro_tpu_torch.pipeline.pixel_stages import (
        run_illumination_qc,
        run_max_projection,
        run_rebin,
    )

    res = size // 2
    fields, _ = synthetic_sites(n_fields, size, seed)
    rng = np.random.default_rng(seed + 1)
    n_img = n_fields * len(CHANNELS)
    secs = {}
    with tempfile.TemporaryDirectory() as root:
        os.makedirs(os.path.join(root, "Images"))
        rows, want = [], {}
        for f in range(n_fields):
            planes = {ch: [] for ch in CHANNELS}
            for p in range(n_planes):
                for c, ch in enumerate(CHANNELS):
                    plane = fields[f, ..., c] + rng.integers(0, 64, (size, size), dtype=np.uint16)
                    name = f"F{f}_{ch}_p{p}.tiff"
                    tiff.imwrite(os.path.join(root, "Images", name), plane)
                    planes[ch].append(plane)
                    rows.append({"PlateID": "P1", "Image_PathName": "Images", "Image_FileName": name})
            for ch in CHANNELS:
                want[f"F{f}_{ch}_p0.tiff"] = np.maximum.reduce(planes[ch])
        del fields, planes
        pd.DataFrame(rows).to_csv(os.path.join(root, "index.csv"), index=False)

        t0 = time.perf_counter()
        n = run_max_projection(root, "index.csv", len(CHANNELS), n_planes, root, device=dev)
        secs["max_projection"] = (time.perf_counter() - t0) / n_img
        if n != n_img:
            raise AssertionError(f"max projection wrote {n} of {n_img} images")
        for name, proj in want.items():
            if not np.array_equal(tiff.imread(os.path.join(root, "ImagesStacked", name)), proj):
                raise AssertionError(f"projection {name} differs from np.maximum.reduce")

        t0 = time.perf_counter()
        n = run_rebin(root, "ImagesStacked/", resolution=res, device=dev)
        secs["rebin"] = (time.perf_counter() - t0) / n_img
        binned = os.path.join(root, "Image_binnedsStacked")  # the reference's literal rewrite
        if n != n_img or sorted(os.listdir(binned)) != sorted(want):
            raise AssertionError(f"re-binning wrote {n} images: {sorted(os.listdir(binned))}")
        for name in want:
            img = tiff.imread(os.path.join(binned, name))
            if img.shape != (res, res) or img.dtype != np.uint16:
                raise AssertionError(f"re-binned {name}: {img.shape} {img.dtype}")

        load_data = os.path.join(root, "load_data.csv")
        pd.DataFrame([{"Metadata_Plate": "P1", "Metadata_Well": f"A{f + 1:02}", "Metadata_Site": 1,
                       **{f"FileName_{ch}": f"F{f}_{ch}_p0.tiff" for ch in CHANNELS}}
                      for f in range(n_fields)]).to_csv(load_data, index=False)
        illum_dir = os.path.join(root, "illum")
        t0 = time.perf_counter()
        estimate_illum(["--load-data", load_data, "--data-path", binned, "--channels", *CHANNELS,
                        "--output", illum_dir, "--device", str(dev)])
        secs["estimate_illum"] = (time.perf_counter() - t0) / n_img
        for ch in CHANNELS:
            fn = np.load(os.path.join(illum_dir, f"{ch}_illum.npy"))
            if fn.shape != (res, res) or not np.isfinite(fn).all() or abs(float(fn.mean()) - 1) > 1e-3:
                raise AssertionError(f"illumination function {ch}: {fn.shape}, mean {fn.mean()}")

        t0 = time.perf_counter()
        qc = run_illumination_qc(load_data, binned, list(CHANNELS), os.path.join(root, "qc.csv"),
                                 illum_path=illum_dir, device=dev)
        secs["illumination_qc"] = (time.perf_counter() - t0) / n_img
    cols = [f"ImageQuality_{m}_{ch}" for ch in CHANNELS for m in ("PowerLogLogSlope", "PercentMaximal")]
    if len(qc) != n_fields or any(c not in qc.columns for c in cols) \
            or any("QC_Error" in c for c in qc.columns):
        raise AssertionError(f"QC table {qc.shape}: {list(qc.columns)}")
    if not np.isfinite(qc[cols].to_numpy(np.float64)).all():
        raise AssertionError("non-finite QC values")
    log(f"pixel path: {n_img} images of {size}^2 -> {res}^2; slopes "
        f"{qc[cols[0]].round(4).tolist()} ({cols[0]})")
    return secs


def check_pixel_small_against_cpu(dev):
    """``run_rebin`` and ``run_illumination_qc`` on the card agree with the
    same calls on the CPU on a small plate: re-binned images within 1 unit,
    slopes to 1e-4 relative, PercentMaximal exactly."""
    import pandas as pd

    from saguaro_tpu_torch.io import tiff
    from saguaro_tpu_torch.pipeline.pixel_stages import run_illumination_qc, run_rebin

    images, _ = synthetic_sites(3, 300, seed=12)
    chans = CHANNELS[:2]
    with tempfile.TemporaryDirectory() as root:
        dirs = {}
        for tag, device in (("card", dev), ("cpu", "cpu")):
            base = os.path.join(root, tag)
            os.makedirs(os.path.join(base, "Images"))
            for s in range(3):
                for c, ch in enumerate(chans):
                    tiff.imwrite(os.path.join(base, "Images", f"S{s}_{ch}.tiff"), images[s, ..., c])
            run_rebin(base, "Images/", resolution=128, device=device)
            dirs[tag] = os.path.join(base, "Image_binneds")
        names = sorted(os.listdir(dirs["card"]))
        if len(names) != 6 or names != sorted(os.listdir(dirs["cpu"])):
            raise AssertionError(f"card and CPU re-binned different files: {names}")
        worst = max(int(np.abs(tiff.imread(os.path.join(dirs["card"], n)).astype(np.int64)
                               - tiff.imread(os.path.join(dirs["cpu"], n)).astype(np.int64)).max())
                    for n in names)
        if worst > 1:
            raise AssertionError(f"card and CPU re-binned images differ by {worst} units")
        load_data = os.path.join(root, "load_data.csv")
        pd.DataFrame([{f"FileName_{ch}": f"S{s}_{ch}.tiff" for ch in chans}
                      for s in range(3)]).to_csv(load_data, index=False)
        qc = {tag: run_illumination_qc(load_data, dirs["card"], list(chans),
                                       os.path.join(root, f"qc_{tag}.csv"), device=device)
              for tag, device in (("card", dev), ("cpu", "cpu"))}
    slope_err = 0.0
    for ch in chans:
        a = qc["card"][f"ImageQuality_PowerLogLogSlope_{ch}"].to_numpy(np.float64)
        b = qc["cpu"][f"ImageQuality_PowerLogLogSlope_{ch}"].to_numpy(np.float64)
        slope_err = max(slope_err, float((np.abs(a - b) / (np.abs(b) + 1e-12)).max()))
        pct = f"ImageQuality_PercentMaximal_{ch}"
        if not np.array_equal(qc["card"][pct].to_numpy(), qc["cpu"][pct].to_numpy()):
            raise AssertionError(f"card and CPU {pct} differ")
    if slope_err > 1e-4:
        raise AssertionError(f"card and CPU slopes differ by {slope_err:.3g} relative")
    log(f"small pixel plate: card vs CPU re-binned within {worst} unit(s), slopes within "
        f"{slope_err:.3g} relative, PercentMaximal equal")


def feature_config(**kw):
    """The reference's default FeatureConfig: every family on."""
    from saguaro_tpu_torch.pipeline.features import FeatureConfig

    return FeatureConfig(**{"channels": CHANNELS, "max_cells": MAX_CELLS, **kw})


def run_main_path(images, gt_labels, device, engine_cfg=None):
    """Segment (engine), recover masks on ground-truth flows, measure.
    Returns (tables per site, recovered labels, seconds per site by stage)."""
    from saguaro_tpu_torch.kernels.flow_ode import centroid_flows, compute_masks_batch
    from saguaro_tpu_torch.pipeline.features import measure_site_batch
    from saguaro_tpu_torch.pipeline.segment_embed import SegmentEmbedConfig, SegmentEmbedEngine

    b = len(images)
    cfg = engine_cfg or SegmentEmbedConfig(channels=list(CHANNELS), diameter=100.0)
    engine = SegmentEmbedEngine(cfg, seed=0, device=device)
    t0 = time.perf_counter()
    seg = engine.segment_batch(images)
    sync(device)
    t_seg = (time.perf_counter() - t0) / b
    if len(seg) != b or any(tuple(s.shape) != images.shape[1:3] for s in seg):
        raise AssertionError("segment_batch returned the wrong shapes")
    # untrained weights find no cells: recover masks from ground-truth flows
    flows = np.stack([centroid_flows(g) for g in gt_labels]) * 5.0
    prob = np.where(gt_labels > 0, 5.0, -5.0).astype(np.float32)
    t0 = time.perf_counter()
    rec = compute_masks_batch(flows, prob, device=device)
    t_rec = (time.perf_counter() - t0) / b
    t0 = time.perf_counter()
    tables = measure_site_batch(images, np.stack(rec), feature_config(), device=device)
    t_meas = (time.perf_counter() - t0) / b
    return tables, rec, {"segment": t_seg, "recover": t_rec, "measure": t_meas}


def check_recovery(rec, gt):
    """Recovered labels cover the ground-truth cells one to one, IoU >= 0.95."""
    for r, g in zip(rec, gt):
        n_gt = int(g.max())
        if int(r.max()) != n_gt:
            raise AssertionError(f"recovered {int(r.max())} cells, expected {n_gt}")
        inter = np.zeros((n_gt + 1, n_gt + 1))
        np.add.at(inter, (r.reshape(-1), g.reshape(-1)), 1)
        best = inter[1:, 1:].max(axis=1)
        union = inter[1:, :].sum(axis=1) + inter[:, 1:].sum(axis=0)[inter[1:, 1:].argmax(axis=1)] - best
        if (best / union).min() < 0.95:
            raise AssertionError(f"recovered mask IoU {float((best / union).min()):.3f} < 0.95")


def run_single_site(images, gt, dev, crop: int = 360) -> dict:
    """The single-site path on the card: ``SegmentEmbedEngine.segment`` on
    one site (its labels' shape and type checked), and Euler
    ``compute_masks`` on a site's ground-truth centroid flows, held against
    the ground truth (IoU >= 0.95 a cell) and, on a ``crop`` x ``crop``
    corner, against the same call on the CPU (equal labels: the steps sum
    as the reference does, in the same order on both devices). Returns
    seconds: segment a site, Euler recovery of a site."""
    from saguaro_tpu_torch.kernels.flow_ode import centroid_flows, compute_masks
    from saguaro_tpu_torch.pipeline.segment_embed import SegmentEmbedConfig, SegmentEmbedEngine

    engine = SegmentEmbedEngine(SegmentEmbedConfig(channels=list(CHANNELS), diameter=100.0),
                                seed=0, device=dev)
    engine.segment(images[1])
    sync(dev)
    t0 = time.perf_counter()
    lab = engine.segment(images[0])
    t_seg = time.perf_counter() - t0
    if lab.shape != images.shape[1:3] or lab.dtype != np.int32:
        raise AssertionError(f"segment returned {lab.shape} {lab.dtype}")
    flows = centroid_flows(gt[0]) * 5.0
    prob = np.where(gt[0] > 0, 5.0, -5.0).astype(np.float32)
    t0 = time.perf_counter()
    rec = compute_masks(flows, prob, device=dev)
    t_rec = time.perf_counter() - t0
    check_recovery([rec], gt[:1])
    part = gt[0, :crop, :crop]
    ids = np.unique(part[part > 0])
    # cells cut by the crop's edge stay in: the flows are the crop's own
    part = np.searchsorted(np.concatenate([[0], ids]), part).astype(np.int32)
    f_part = centroid_flows(part) * 5.0
    p_part = np.where(part > 0, 5.0, -5.0).astype(np.float32)
    on_card = compute_masks(f_part, p_part, device=dev)
    on_cpu = compute_masks(f_part, p_part, device="cpu")
    if not np.array_equal(on_card, on_cpu):
        raise AssertionError(f"Euler masks on the card and the CPU differ at "
                             f"{int((on_card != on_cpu).sum())} pixels")
    log(f"single site: segment {t_seg:.4f} s ({int(lab.max())} masks, untrained weights); Euler "
        f"recovery {t_rec:.4f} s, {int(rec.max())} cells, IoU >= 0.95; {crop}^2 crop: card and "
        f"CPU labels equal ({int(on_cpu.max())} cells)")
    return {"segment": t_seg, "recover_euler": t_rec}


def check_tables(tables, n_cells):
    for t in tables:
        if set(t) != {"Image", "Nuclei", "Cells", "Cytoplasm"}:
            raise AssertionError(f"tables {sorted(t)}")
        for name in ("Nuclei", "Cells", "Cytoplasm"):
            if len(t[name]) != n_cells:
                raise AssertionError(f"{name}: {len(t[name])} rows, expected {n_cells}")
        for name, df in t.items():
            vals = df.select_dtypes("number").to_numpy(np.float64)
            if not np.isfinite(vals).all():
                raise AssertionError(f"{name}: non-finite values")


# columns whose value is a small difference of large sums for the
# synthetic round cells (odd and mixed moments, m=1 Zernike, orientation of
# a near-circle): their sums are held against the plain forms at full size
# in check_kernels instead
ILL_CONDITIONED = ("Moment", "Zernike", "Orientation", "Eccentricity", "MassDisplacement",
                   "InertiaTensor")


def check_small_against_cpu(dev):
    """The measurement on the card (kernels) agrees with the CPU (plain
    forms) on a small 2-site batch, to 1e-4 of each well-conditioned
    column's scale."""
    images, labels = synthetic_sites(2, 200, seed=5)
    from saguaro_tpu_torch.pipeline.features import measure_site_batch

    cfg = feature_config(max_cells=64)
    on_card = measure_site_batch(images, labels, cfg, device=dev)
    on_cpu = measure_site_batch(images, labels, cfg, device="cpu")
    worst = 0.0
    for a, c in zip(on_card, on_cpu):
        for name in a:
            if list(a[name].columns) != list(c[name].columns) or len(a[name]) != len(c[name]):
                raise AssertionError(f"{name}: card and CPU tables differ in shape")
            cols = [k for k in a[name].select_dtypes("number").columns
                    if not any(t in k for t in ILL_CONDITIONED)]
            x = a[name][cols].to_numpy(np.float64)
            y = c[name][cols].to_numpy(np.float64)
            scale = np.abs(y).max(axis=0, keepdims=True) + 1e-12
            worst = max(worst, float((np.abs(x - y) / scale).max(initial=0.0)))
    if worst > 1e-4:
        raise AssertionError(f"card vs CPU measurement differs by {worst:.3g} of column scale")
    log(f"small batch: card vs CPU worst column-relative difference {worst:.3g}")


# --------------------------------------------------------------------------
# The fine Costes descent, the oracles of the fused
# measurement, the legacy granularity spectrum, the device mesh

FINE_SCALE = 65535          # CP's linear_costes at the uint16 bit depth
K3_FINE_SITE = "costes_fine_refine"
# the fused measurement against its oracles: rtol 1e-4 and
# tests/test_fused_measure.py's atol by family (1e-3 for the intensity and
# edge families, 1e-4 else); a column whose values are small differences of
# large sums (odd central moments of round cells, MassDisplacement) may
# instead meet tests/torch_data.feature_tolerance, the CPU tests' bound
ORACLE_RTOL = 1e-4
ORACLE_ATOL = {"moments": 1e-4, "intensity": 1e-3, "edge": 1e-3, "radial": 1e-4, "corr": 1e-4,
               "shape": 1e-4, "zernike": 1e-5}
ORACLE_COLUMN = {"moments": "AreaShape_{}", "intensity": "Intensity_{}", "edge": "Intensity_{}",
                 "radial": "RadialDistribution_{}", "corr": "Correlation_{}",
                 "shape": "AreaShape_{}", "zernike": "AreaShape_Zernike_{}"}
GRAN_RTOL = 1e-5            # legacy granularity, card vs CPU, of the spectrum's scale
MESH_LOSS_RTOL = 1e-5       # training with and without the mesh, relative loss


def sync(dev) -> None:
    """Wait for ``dev``'s queued work (nothing to wait for on the CPU)."""
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def fine_window(prev_k, fine: int, scale: int, fast: bool = True):
    """The fine grid indices ``costes_fine_refine``'s walk can stop at, from
    the coarse bracket's top: (lowest, highest)."""
    from saguaro_tpu_torch.kernels.colocalization import fine_candidates

    r = fine // scale
    return prev_k * r - (fine_candidates(scale, fine, fast) - 1), prev_k * r


def run_fine_costes(images, rec, dev, n_cells):
    """The second-level Costes descent on the main path's batch: one
    ``measure_site_batch`` at the default FeatureConfig with
    ``costes_fine_scale`` = 65535 (its own launch counts, K3 by call site:
    K3 must run at ``costes_fine_refine``; every table and Costes column
    finite); s/site beside the default's; each site's and pair's fine walk
    of the nuclei stopped on CP's rule (a Pearson <= 0 or fewer than 2
    pixels below), none run off its window's bottom (how many thresholds
    lie inside the coarse bracket [thr_k, prev_k] is logged). Returns (numbers, the K3Sites record of the fine run, whose
    first inputs at ``costes_fine_refine`` main holds and times K3 on)."""
    import torch

    from saguaro_tpu_torch.kernels import segment_cuda as sc
    from saguaro_tpu_torch.kernels.colocalization import costes_fine_refine, costes_thresholds
    from saguaro_tpu_torch.kernels.segment_cuda import _pairs
    from saguaro_tpu_torch.pipeline.features import measure_site_batch

    labels = np.stack(rec)
    b = len(images)
    times = {}
    for name, cfg in (("default", feature_config()),
                      ("fine", feature_config(costes_fine_scale=FINE_SCALE))):
        sync(dev)
        if torch.device(dev).type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        sc.reset_launch_counts()
        t0 = time.perf_counter()
        with K3Sites(keep=name == "fine") as k3:
            tables = measure_site_batch(images, labels, cfg, device=dev)
            sync(dev)
        times[name] = (time.perf_counter() - t0) / b
        peak = torch.cuda.max_memory_allocated(dev) if torch.device(dev).type == "cuda" else 0
        launches = dict(sc.LAUNCHES)
        log(f"measure with {name} Costes: {times[name]:.4f} s/site, peak {peak / 1e9:.3f} GB, "
            f"launches {launches}, K3 by call site {k3.calls}")
    if K3_FINE_SITE not in k3.calls:
        raise AssertionError(f"the fine Costes measurement did not launch K3 at {K3_FINE_SITE}: "
                             f"{k3.calls}")
    check_tables(tables, n_cells)
    n_costes = 0
    for t in tables:
        for name in ("Nuclei", "Cells", "Cytoplasm"):
            cols = [c for c in t[name].columns if c.startswith("Correlation_Costes_")]
            n_costes += len(cols)
            if not cols or not np.isfinite(t[name][cols].to_numpy(np.float64)).all():
                raise AssertionError(f"{name}: Costes columns missing or not finite")

    # the nuclei's thresholds against the coarse bracket, every site and pair
    pairs = tuple(_pairs(len(CHANNELS)))
    vn = torch.as_tensor(images.reshape(b, -1, len(CHANNELS)).astype(np.float32),
                         device=dev) / 65535.0
    inside = torch.as_tensor(labels.reshape(b, -1) > 0, device=dev)
    _, _, (regs, thr_k, prev_k) = costes_thresholds(vn, inside, pairs, return_bracket=True)
    fine_f, _, truncated = costes_fine_refine(vn, inside, pairs, regs, prev_k, fine=FINE_SCALE,
                                              return_truncated=True)
    kf = np.round(fine_f.cpu().numpy().astype(np.float64) * FINE_SCALE)
    tk = thr_k.cpu().numpy().astype(np.float64)
    pk = prev_k.cpu().numpy().astype(np.float64)
    lo, _ = fine_window(pk, FINE_SCALE, 255)
    r = FINE_SCALE // 255
    if truncated.any():
        at = [tuple(int(i) for i in x) for x in np.argwhere(truncated)]
        raise AssertionError(f"{len(at)} fine Costes walks (site, pair) {at} ran off the window's "
                             f"bottom with the Pearson still positive: thresholds {kf[truncated]}, "
                             f"window bottoms {lo[truncated]}")
    in_bracket = int(((kf >= tk * r) & (kf <= pk * r)).sum())
    log(f"fine Costes (nuclei, {b} sites x {len(pairs)} pairs): every walk stopped on CP's rule "
        f"(0 ran off the window); {in_bracket} of {kf.size} thresholds inside the coarse bracket "
        f"[thr_k, prev_k]; fine minus coarse stop {np.unique(kf - tk * r).astype(int).tolist()} "
        f"fine steps; lowest stop {float((kf - lo).min()):.0f} fine steps above its window's bottom")
    del vn, inside

    _, val, mc = k3.inputs[K3_FINE_SITE]
    return {"measure_default_s_per_site": times["default"],
            "measure_fine_s_per_site": times["fine"], "costes_columns": n_costes,
            "in_bracket": in_bracket, "thresholds": int(kf.size), "truncated": 0,
            "k3_shape": [*val.shape, mc], "k3_launches": k3.calls[K3_FINE_SITE]}, k3


def check_fine_costes_against_cpu(images, rec, dev, size: int = CPU_CHECK_SIZE) -> dict:
    """The fine descent on a ``size``² corner of every site, card against
    CPU (K3 against its plain form, the f32 sums in another order): every
    threshold within 2 fine steps; where the two are equal, C1 and C2
    within SUM_RTOL (and 1e-6)."""
    import torch

    from saguaro_tpu_torch.kernels.colocalization import colocalization_features

    img = images[:, :size, :size].astype(np.float32)
    lab = np.ascontiguousarray(np.stack(rec)[:, :size, :size])
    vmax = np.zeros((len(img), MAX_CELLS, len(CHANNELS)), np.float32)
    out = {}
    for d in (dev, "cpu"):
        out[str(d)] = colocalization_features(
            torch.as_tensor(img, device=d), torch.as_tensor(lab, device=d),
            torch.as_tensor(vmax, device=d), MAX_CELLS, costes_fine_scale=FINE_SCALE)
    card, cpu = out[str(dev)], out["cpu"]
    tf_card = card["costes_thr"][0].cpu().numpy().astype(np.float64)
    tf_cpu = cpu["costes_thr"][0].numpy().astype(np.float64)
    steps = np.abs(tf_card - tf_cpu) * FINE_SCALE
    if steps.max() > 2.0 + 1e-3:
        raise AssertionError(f"fine Costes thresholds card vs CPU differ by {steps.max():.1f} steps")
    worst, n_equal = 0.0, 0
    for i, key in enumerate(k for k in cpu if k != "costes_thr"):
        for s in range(len(img)):
            if tf_card[s, i] != tf_cpu[s, i]:
                continue
            n_equal += 1
            for stat in ("C1", "C2"):
                g = card[key][stat][s].cpu().double()
                c = cpu[key][stat][s].double()
                ratio = float(((g - c).abs() / (SUM_RTOL * c.abs() + 1e-6)).max())
                worst = max(worst, ratio)
    if worst > 1.0:
        raise AssertionError(f"fine Costes C1/C2 card vs CPU beyond SUM_RTOL ({worst:.3g} of it)")
    log(f"fine Costes {size}² corners, card vs CPU: thresholds within {steps.max():.0f} fine steps "
        f"({int((steps == 0).sum())} of {steps.size} equal); C1/C2 where equal within "
        f"{worst:.3g} of SUM_RTOL")
    return {"max_steps": float(steps.max()), "equal": int(n_equal), "c_worst_of_tol": worst}


def ring_tie_allowance(images, labels, n_rings: int, max_cells: int, tie: float = 1e-4):
    """How far centroid ring binning (``dist / dmax * n_rings``, floored)
    may move between two f32 computations of the centroids: a pixel whose
    ring coordinate lies within ``tie`` of a ring boundary (the exact disks
    of ``synthetic_sites`` put whole circles of pixels there) can fall on
    either side. Computed in f64 on the host; returns the allowances
    (B, max_cells, n_rings, C) of FracAtD (those pixels' share of the
    object's channel sum, for each ring they border) and of MeanFrac (the
    same over the ring's pixel share, plus the ring's count moving by those
    pixels)."""
    b, h, w, n_ch = images.shape
    frac = np.zeros((b, max_cells, n_rings, n_ch))
    mean = np.zeros_like(frac)
    yy, xx = np.mgrid[:h, :w]
    for s in range(b):
        lab = labels[s].reshape(-1)
        on = (lab > 0) & (lab < max_cells)
        ids, y, x = lab[on], yy.reshape(-1)[on].astype(np.float64), xx.reshape(-1)[on].astype(np.float64)
        v = images[s].reshape(-1, n_ch)[on].astype(np.float64)
        cnt = np.bincount(ids, minlength=max_cells).astype(np.float64)
        den = np.maximum(cnt, 1.0)
        cy = np.bincount(ids, y, max_cells) / den
        cx = np.bincount(ids, x, max_cells) / den
        d = np.hypot(y - cy[ids], x - cx[ids])
        dmax = np.zeros(max_cells)
        np.maximum.at(dmax, ids, d)
        pos = d / np.maximum(dmax[ids], 1e-6) * n_rings
        k = np.round(pos)
        near = (np.abs(pos - k) < tie) & (k >= 1) & (k <= n_rings - 1)
        ring = np.clip(pos.astype(np.int64), 0, n_rings - 1)
        ring_cnt = np.zeros((max_cells, n_rings))
        np.add.at(ring_cnt, (ids, ring), 1.0)
        total = np.zeros((max_cells, n_ch))
        np.add.at(total, ids, v)
        moved_v = np.zeros((max_cells, n_rings, n_ch))
        moved_n = np.zeros((max_cells, n_rings))
        for side in (0, 1):  # the rings on either side of the boundary k
            r = (k[near] - side).astype(np.int64)
            np.add.at(moved_v, (ids[near], r), v[near])
            np.add.at(moved_n, (ids[near], r), 1.0)
        tot = np.maximum(total, 1e-12)[:, None, :]
        frac[s] = moved_v / tot
        # MeanFrac = F / p with F the ring's intensity share and p its pixel
        # share; moving pixels of share q and intensity share f changes it
        # by at most (f + MeanFrac q) / (p - q)
        pix = np.maximum(ring_cnt / den[:, None], 1e-12)[..., None]
        pix_lo = (np.maximum(ring_cnt - moved_n, 1.0) / den[:, None])[..., None]
        ring_frac = np.zeros((max_cells, n_rings, n_ch))
        np.add.at(ring_frac, (ids, ring), v)
        mf = ring_frac / tot / pix
        mean[s] = (frac[s] + mf * (moved_n / den[:, None])[..., None]) / pix_lo
    return frac, mean


def oracle_tolerance(family, key, want, area, side, h, w):
    """The tolerance of an oracle's values ``want`` (B, max_cells, ...)
    against the fused measurement's: ORACLE_ATOL[family] + ORACLE_RTOL *
    |want|, or ``feature_tolerance`` of its column where that is larger,
    with each object's area and box side (B, max_cells) for the moment
    columns' scale."""
    import pandas as pd

    from tests.torch_data import feature_tolerance

    tol = ORACLE_ATOL[family] + ORACLE_RTOL * np.abs(want)
    col = ORACLE_COLUMN[family].format(key)
    for s in range(len(want)):
        # feature_tolerance reads areas and box sides from a table
        table = pd.DataFrame({"AreaShape_Area": area[s],
                              "AreaShape_BoundingBoxMaximum_Y": side[s],
                              "AreaShape_BoundingBoxMinimum_Y": 0.0,
                              "AreaShape_BoundingBoxMaximum_X": 0.0,
                              "AreaShape_BoundingBoxMinimum_X": 0.0})
        ws = want[s].reshape(len(area[s]), -1)
        for j in range(ws.shape[1]):
            scaled = feature_tolerance(col, ws[:, j], table, h, w)
            t = tol[s].reshape(ws.shape)
            t[:, j] = np.maximum(t[:, j], scaled)
            tol[s] = t.reshape(tol[s].shape)
    return tol


def check_oracles(images, labels, dev) -> dict:
    """``moments_features`` and the three ``multichannel_*`` functions on
    the card (sums on K3, at four call sites) against the fused
    measurement's columns on the 8 sites: ORACLE_RTOL and ORACLE_ATOL, or
    ``feature_tolerance`` where it is larger (1e-5 of area x side^(p+q) for
    raw, central and normalized moments, 1e-3 for Hu, 1e-6 of the side for
    MassDisplacement); the radial family also by what its pixels on a ring
    boundary may move (``ring_tie_allowance``: the two sides' centroids
    differ in their last bits). Returns the worst ratio to the tolerance by family,
    to rtol = 1e-4 with the family's atol alone, and K3's launches by
    site."""
    import torch

    from saguaro_tpu_torch.kernels import segment_cuda as sc
    from saguaro_tpu_torch.kernels.fused_measure import fused_object_features
    from saguaro_tpu_torch.kernels.moments import moments_features
    from saguaro_tpu_torch.kernels.multichannel import (
        edge_intensity_multichannel,
        multichannel_stats,
        radial_distribution_multichannel,
    )

    img = torch.as_tensor(images.astype(np.float32), device=dev)
    lab = torch.as_tensor(np.ascontiguousarray(labels), device=dev)
    sync(dev)
    sc.reset_launch_counts()
    t0 = time.perf_counter()
    with K3Sites(keep=False) as k3:
        oracle = {"moments": moments_features(lab, MAX_CELLS)}
        oracle["intensity"], corr = multichannel_stats(img, lab, MAX_CELLS)
        oracle["edge"] = edge_intensity_multichannel(img, lab, MAX_CELLS)
        oracle["radial"] = radial_distribution_multichannel(img, lab, MAX_CELLS, 4)
        sync(dev)
    secs = time.perf_counter() - t0
    launches = dict(sc.LAUNCHES)
    want_sites = {"moments_features", "multichannel_stats", "edge_intensity_multichannel",
                  "radial_distribution_multichannel"}
    if not want_sites <= set(k3.calls):
        raise AssertionError(f"the oracles launched K3 at {k3.calls}")
    fused = fused_object_features(img, lab, MAX_CELLS, n_rings=4)
    area = fused["shape"]["Area"].cpu().numpy().astype(np.float64)
    side = np.maximum(
        (fused["shape"]["BoundingBoxMaximum_Y"] - fused["shape"]["BoundingBoxMinimum_Y"]).cpu().numpy(),
        (fused["shape"]["BoundingBoxMaximum_X"] - fused["shape"]["BoundingBoxMinimum_X"]).cpu().numpy(),
    ).astype(np.float64)
    worst: dict[str, float] = {}
    failures = []
    ties = dict(zip(("FracAtD", "MeanFrac"), ring_tie_allowance(images, labels, 4, MAX_CELLS)))
    log(f"oracles: pixels on a ring boundary move FracAtD by up to {ties['FracAtD'].max():.3g} "
        f"and MeanFrac by up to {ties['MeanFrac'].max():.3g}")

    def hold(family, key, got, want):
        g = got.double().cpu().numpy()
        w = want.double().cpu().numpy()
        strict = float((np.abs(g - w) / (ORACLE_ATOL[family] + ORACLE_RTOL * np.abs(w))).max())
        tol = oracle_tolerance(family, key, w, area, side, *images.shape[1:3])
        if family == "radial":
            tol = tol + ties[key]
        ratio = float((np.abs(g - w) / tol).max())
        worst[family] = max(worst.get(family, 0.0), ratio)
        if ratio > 1.0:
            failures.append(f"{family} {key}: {ratio:.3g} of the tolerance (strict {strict:.3g})")
        return strict

    strict_worst: dict[str, float] = {}
    for family in ("moments", "intensity", "edge", "radial"):
        for key, want in oracle[family].items():
            st = hold(family, key, fused[family][key], want)
            strict_worst[family] = max(strict_worst.get(family, 0.0), st)
    for pair, (c, sl) in corr.items():
        fc, fs = fused["corr"][pair]
        strict_worst["corr"] = max(strict_worst.get("corr", 0.0), hold("corr", "Correlation", fc, c),
                                   hold("corr", "Slope", fs, sl))
    if failures:
        raise AssertionError("the fused measurement differs from its oracles: " + "; ".join(failures))
    log(f"oracles on the card ({secs:.3f} s; launches {launches}, K3 by call site {k3.calls}): worst "
        f"ratio to the tolerance by family {worst}; to rtol = atol = 1e-4 alone {strict_worst}")
    return {"seconds": secs, "k3_calls": dict(k3.calls), "worst_of_tol": worst,
            "strict_worst": strict_worst}


def check_granularity(images, dev) -> dict:
    """The legacy ``granularity_spectrum`` (16 radii) of one 1080² site's
    five channels on the card against the CPU: within GRAN_RTOL of the
    spectrum's scale; seconds of the card's call."""
    import torch

    from saguaro_tpu_torch.kernels.morphology import granularity_spectrum

    planes = np.ascontiguousarray(np.moveaxis(images[0], -1, 0).astype(np.float32))
    x = torch.as_tensor(planes, device=dev)
    granularity_spectrum(x[:1], 2)
    sync(dev)
    t0 = time.perf_counter()
    card = granularity_spectrum(x, 16)
    sync(dev)
    secs = time.perf_counter() - t0
    cpu = granularity_spectrum(torch.as_tensor(planes), 16).double()
    card = card.cpu().double()
    err = float((card - cpu).abs().max())
    scale = float(cpu.abs().max())
    if not torch.isfinite(card).all() or err > GRAN_RTOL * scale:
        raise AssertionError(f"legacy granularity card vs CPU differs by {err:.3g} (scale {scale:.3g})")
    log(f"legacy granularity spectrum, 5 planes of {planes.shape[1]}², 16 radii: card {secs:.3f} s, "
        f"card vs CPU {err:.3g} (scale {scale:.3g})")
    return {"seconds": secs, "max_abs_err": err, "scale": scale}


# --------------------------------------------------------------------------
# The per-family measurement API: the reference's one-family-at-a-time
# functions on the main path's sites

# the segment_cuda functions FamilyInputs wraps, by kernel: the wrappers on
# the card (the CPU rehearsals wrap the plain forms)
FAMILY_WRAPPED = {"seg_counts": "seg_counts", "seg_take_t": "seg_take_t", "seg_sums": "seg_sums",
                  "seg_pick2": "seg_pick2"}
# columns the per-family functions and the fused measurement compute alike
# to the bit (counts, areas, boxes, min / max and their places)
FAMILY_EXACT = ("Area", "BoundingBox", "MinIntensity", "MaxIntensity")
RPS_RTOL = 1e-4             # ring sums of the FFT, card vs CPU (cuFFT vs pocketfft), + 1e-6 of max
TILES_ATOL = 1e-3           # segment_tiles card vs CPU in f32, of the output's largest magnitude
FAMILY_SUM_RTOL = 2.0**-15  # a plain f32 sum, of the per-label sum of |value| (the CPU tests' rule)
FAMILY_TILES = 8            # tiles of 224² segment_tiles runs on
HARALICK_RTOL = 1e-5        # Haralick of equal GLCMs (+ 1e-6): index_add_'s atomics vary its sums' order


class FamilyInputs:
    """Wraps K1's, K2's, K3's and K6's wrappers (FAMILY_WRAPPED) while
    active: counts each kernel's calls and keeps its first inputs."""

    def __init__(self):
        from saguaro_tpu_torch.kernels import segment_cuda as sc

        self.sc, self.calls, self.inputs, self.real = sc, {}, {}, {}

    def __enter__(self):
        for kernel, fname in FAMILY_WRAPPED.items():
            real = self.real[fname] = getattr(self.sc, fname)

            def counted(*args, _kernel=kernel, _real=real, **kw):
                self.calls[_kernel] = self.calls.get(_kernel, 0) + 1
                self.inputs.setdefault(_kernel, args)
                return _real(*args, **kw)

            setattr(self.sc, fname, counted)
        return self

    def __exit__(self, *exc):
        for fname, real in self.real.items():
            setattr(self.sc, fname, real)


def family_calls(img, lab, fused, model, tiles) -> dict:
    """{API function: zero-argument call} of every per-family function at
    the phase's inputs: image (B, H, W, 5) f32 and labels on one device,
    the fused measurement's stats for the ranges texture and quantiles are
    given (as the measurement gives them), the CPnet and its tiles. The
    one-channel forms take DNA, correlation (DNA, GFP)."""
    import torch

    from saguaro_tpu_torch.kernels import colocalization, glcm, objects_extra, qc, segment_reduce
    from saguaro_tpu_torch.kernels.zernike import zernike_features
    from saguaro_tpu_torch.models.cellpose import segment_tiles
    from saguaro_tpu_torch.pipeline.features import otsu_threshold

    b, h, w, n_ch = img.shape
    dna = img[..., 0].contiguous()
    cnt, vmin, vmax = fused["stats"]
    codes = img.reshape(b, h * w, n_ch).round().to(torch.int32)
    return {
        "segment_stats": lambda: segment_reduce.segment_stats(dna, lab, MAX_CELLS),
        "intensity_features": lambda: segment_reduce.intensity_features(dna, lab, MAX_CELLS),
        "shape_features": lambda: segment_reduce.shape_features(lab, MAX_CELLS),
        "correlation_features": lambda: segment_reduce.correlation_features(
            dna, img[..., 1].contiguous(), lab, MAX_CELLS),
        "zernike_features": lambda: zernike_features(lab, MAX_CELLS),
        "object_glcm": lambda: glcm.object_glcm(dna, lab, MAX_CELLS, 16, 3,
                                                stats=(vmin[..., 0], vmax[..., 0])),
        "object_glcm_scatter": lambda: glcm.object_glcm_scatter(dna, lab, MAX_CELLS, 16, 3),
        "quantile_intensity_features": lambda: objects_extra.quantile_intensity_features(
            dna, lab, MAX_CELLS, stats=(cnt, vmin[..., 0], vmax[..., 0])),
        "edge_intensity_features": lambda: objects_extra.edge_intensity_features(dna, lab, MAX_CELLS),
        "radial_distribution_features": lambda: objects_extra.radial_distribution_features(
            dna, lab, MAX_CELLS, 4),
        "dense_rank_images": lambda: colocalization.dense_rank_images(
            codes, lab.reshape(b, -1) > 0),
        "otsu_threshold": lambda: otsu_threshold(img.permute(0, 3, 1, 2).reshape(-1, h, w)),
        "radial_power_spectrum": lambda: qc.radial_power_spectrum(dna),
        "segment_tiles": lambda: segment_tiles(model, tiles),
    }


def family_outputs(name: str, out) -> dict:
    """One per-family function's output as {key: tensor}."""
    if name == "segment_stats":
        return dict(zip(("count", "sum", "sumsq", "min", "max"), out))
    if name == "dense_rank_images":
        return dict(zip(("ranks", "n_distinct"), out))
    if name == "radial_power_spectrum":
        return dict(zip(("magsum", "powersum"), out[1:]))
    return out if isinstance(out, dict) else {"": out}


def family_model_and_tiles(images, dev, n_tiles: int = FAMILY_TILES):
    """The full-width CPnet in f32 (seeded weights, the same on every
    device) and ``n_tiles`` tiles of the sites' first two channels, scaled
    to O(1): 224² (the CLI's tile), or the sites' side where smaller."""
    import torch

    from saguaro_tpu_torch.models.cellpose import CellposeConfig, init_cellpose

    cfg = CellposeConfig(compute_dtype="float32")
    b, h = images.shape[:2]
    t = min(cfg.tile, h) // 8 * 8
    model = init_cellpose(cfg, seed=0, device=dev)
    picks = [images[i % b, (i // b * t) % (h - t + 1):][:t, :t, :2] for i in range(n_tiles)]
    return model, torch.as_tensor(np.stack(picks).astype(np.float32) / 1000.0, device=dev)


def run_family_api(images, labels, dev, corner: int = CPU_CHECK_SIZE) -> tuple[dict, dict]:
    """Every per-family function on the sites (labels the ground truth):
    each run alone, its K1, K2, K3 and K6 launches counted and their first
    inputs kept; held against the fused measurement's columns where a family
    coincides (``hold_family_against_fused``), and card against CPU on
    ``corner``² corners (``hold_family_against_cpu``), with the main path's
    ring/wedge codes of the min-plus scan race held exactly there. Returns
    (numbers, {API function: (launches by kernel, FamilyInputs)})."""
    import torch

    from saguaro_tpu_torch.device import full_f32
    from saguaro_tpu_torch.kernels import segment_cuda as sc
    from saguaro_tpu_torch.kernels.fused_measure import fused_object_features

    img = torch.as_tensor(images.astype(np.float32), device=dev)
    lab = torch.as_tensor(np.ascontiguousarray(labels), device=dev)
    fused = fused_object_features(img, lab, MAX_CELLS, n_rings=4)
    model, tiles = family_model_and_tiles(images, dev)
    on_card = torch.device(dev).type == "cuda"
    outs, runs, secs = {}, {}, {}
    with full_f32():
        for name, fn in family_calls(img, lab, fused, model, tiles).items():
            sync(dev)
            sc.reset_launch_counts()
            t0 = time.perf_counter()
            with FamilyInputs() as rec:
                outs[name] = family_outputs(name, fn())
                sync(dev)
            secs[name] = time.perf_counter() - t0
            launches = {k: sc.LAUNCHES[k] for k in rec.calls} if on_card else dict(rec.calls)
            runs[name] = (launches, rec)
    log("family API at the main path's sites: seconds " + json.dumps(secs) + "; launches "
        + json.dumps({k: v[0] for k, v in runs.items()}))
    reached = {k for launches, _ in runs.values() for k, n in launches.items() if n > 0}
    if set(FAMILY_WRAPPED) - reached:
        raise AssertionError(f"the family API did not launch {sorted(set(FAMILY_WRAPPED) - reached)}")
    worst = hold_family_against_fused(images, labels, img, lab, fused, outs)
    del outs, fused, img, lab, model, tiles
    cpu = hold_family_against_cpu(images, labels, dev, corner)
    return {"seconds": secs, "worst_of_tol": worst, "cpu_worst_of_tol": cpu,
            "launches": {k: v[0] for k, v in runs.items()}}, runs


def _exact(what, got, want):
    import torch

    if not torch.equal(got.cpu(), want.cpu()):
        raise AssertionError(f"family API {what} differs")


def _edge_var_tol(mean, std):
    """The Edge set's std is compared as a variance: ``sumsq / n - mean**2``
    cancels in f32 to FAMILY_SUM_RTOL of the mean square."""
    return FAMILY_SUM_RTOL * (mean.double() ** 2 + std.double() ** 2).cpu().numpy()


def hold_family_against_fused(images, labels, img, lab, fused, outs) -> dict:
    """The per-family outputs against the fused measurement's columns, and
    against the measurement's texture and quantile functions, on the
    phase's sites: counts and FAMILY_EXACT columns, GLCMs (both
    formulations) and the quantiles exactly; the
    others within ``oracle_tolerance`` (the radial family also by what its
    pixels on a ring boundary may move, ``ring_tie_allowance``; the Edge
    std as a variance, ``_edge_var_tol``); the Haralick statistics of the
    equal GLCMs within HARALICK_RTOL. Returns the worst ratio to the
    tolerance by family."""
    import torch

    from saguaro_tpu_torch.kernels.glcm import (
        haralick_features,
        object_glcm_multichannel,
        quantize_channels,
    )
    from saguaro_tpu_torch.kernels.objects_extra import quantile_intensity_features_mc
    from saguaro_tpu_torch.kernels.onehot_reduce import mxu_take_t
    from saguaro_tpu_torch.kernels.segment_reduce import _flat

    b, h, w, n_ch = images.shape
    sh = fused["shape"]
    area = sh["Area"].cpu().numpy().astype(np.float64)
    side = np.maximum((sh["BoundingBoxMaximum_Y"] - sh["BoundingBoxMinimum_Y"]).cpu().numpy(),
                      (sh["BoundingBoxMaximum_X"] - sh["BoundingBoxMinimum_X"]).cpu().numpy()
                      ).astype(np.float64)
    worst: dict[str, float] = {}
    ties = dict(zip(("FracAtD", "MeanFrac"), ring_tie_allowance(images, labels, 4, MAX_CELLS)))

    def hold(family, key, got, want, extra=0.0):
        if key.startswith(FAMILY_EXACT):
            _exact(f"{family} {key}", got, want)
            return
        g = got.double().cpu().numpy()
        wv = want.double().cpu().numpy()
        tol = oracle_tolerance(family, key, wv, area, side, h, w) + extra
        ratio = float((np.abs(g - wv) / tol).max())
        worst[family] = max(worst.get(family, 0.0), ratio)
        if ratio > 1.0:
            raise AssertionError(f"family API {family} {key}: {ratio:.3g} of the tolerance")

    cnt, vmin, vmax = fused["stats"]
    st = outs["segment_stats"]
    _exact("segment_stats count", st["count"], cnt)
    _exact("segment_stats min", st["min"], vmin[..., 0])
    _exact("segment_stats max", st["max"], vmax[..., 0])
    hold("intensity", "IntegratedIntensity", st["sum"], fused["intensity"]["IntegratedIntensity"][..., 0])
    for key, v in outs["intensity_features"].items():
        hold("intensity", key, v, fused["intensity"][key][..., 0])
    for key, v in outs["shape_features"].items():
        hold("shape", key, v, sh[key])
    hold("zernike", "0_0", outs["zernike_features"][""], fused["zernike"])
    for i, key in enumerate(("Correlation", "Slope")):
        hold("corr", key, outs["correlation_features"][key], fused["corr"][(0, 1)][i])
    edge = fused["edge"]
    for key, v in outs["edge_intensity_features"].items():
        want = edge[key][..., 0]
        if key == "StdIntensityEdge":
            hold("edge", "Std", v.double() ** 2, want.double() ** 2,
                 extra=_edge_var_tol(edge["MeanIntensityEdge"][..., 0], want))
        else:
            hold("edge", key, v, want)
    for key, v in outs["radial_distribution_features"].items():
        hold("radial", key, v, fused["radial"][key][..., 0], extra=ties[key][..., 0])

    # texture: the measurement's GLCMs of the same channel, from its ranges
    vrange = torch.clamp(vmax - vmin, min=1e-12)
    g = mxu_take_t(torch.cat([vmin, vrange], dim=2), _flat(lab, MAX_CELLS), MAX_CELLS)
    q = quantize_channels(img[..., :1], lab, 16, (g[:, :1], g[:, n_ch:n_ch + 1]))
    want_glcm = object_glcm_multichannel(lab, MAX_CELLS, 16, 3, q)[:, 0]
    del g, q
    _exact("object_glcm", outs["object_glcm"][""], want_glcm)
    _exact("object_glcm_scatter", outs["object_glcm_scatter"][""], want_glcm)
    # the same GLCMs: the statistics differ only by index_add_'s atomics
    har = haralick_features(want_glcm)
    for key, v in haralick_features(outs["object_glcm"][""]).items():
        g_, w_ = v.double().cpu(), har[key].double().cpu()
        if not bool(((g_ - w_).abs() <= HARALICK_RTOL * w_.abs() + 1e-6).all()):
            raise AssertionError(f"family API Haralick {key} differs beyond HARALICK_RTOL")
    del want_glcm, har

    quant = quantile_intensity_features_mc(img[..., :1], lab, MAX_CELLS,
                                           stats=(cnt, vmin[..., :1], vmax[..., :1]))
    for key, v in outs["quantile_intensity_features"].items():
        _exact(f"quantiles {key}", v, quant[key][..., 0])
    log(f"family API against the measurement: counts, boxes, min/max, GLCMs and quantiles exact, "
        f"Haralick within {HARALICK_RTOL}; worst ratio to the tolerance by family {worst}")
    return worst


def hold_family_against_cpu(images, labels, dev, corner: int) -> dict:
    """Every per-family function on ``corner``² corners of the sites (two
    tiles of the corner for segment_tiles), card against CPU: integer
    results (counts, areas, boxes, min / max, GLCMs, quantiles, dense
    ranks, Otsu thresholds) exactly; segment_stats' sums within
    FAMILY_SUM_RTOL of the per-label sum of |value|, derived columns within
    ``oracle_tolerance`` (the Edge std as a variance, ``_edge_var_tol``);
    the ring sums of the FFT within RPS_RTOL (+ 1e-6 of the largest ring);
    segment_tiles within TILES_ATOL of its largest output; and the min-plus
    race's ring/wedge codes (``cp_ring_wedge``, the main path's radial
    geometry) exactly. The ILL_CONDITIONED columns (Orientation,
    Eccentricity, MassDisplacement, Zernike: small differences of large
    sums for round cells) are logged, not held, as in
    ``check_small_against_cpu``. Returns the worst ratio to the tolerance
    by function (0 where exact)."""
    import torch

    from saguaro_tpu_torch.device import full_f32
    from saguaro_tpu_torch.kernels.fused_measure import fused_object_features
    from saguaro_tpu_torch.kernels.radial import cp_ring_wedge

    img_np = np.ascontiguousarray(images[:, :corner, :corner].astype(np.float32))
    lab_np = np.ascontiguousarray(labels[:, :corner, :corner])
    out = {}
    for d in (dev, "cpu"):
        img = torch.as_tensor(img_np, device=d)
        lab = torch.as_tensor(lab_np, device=d)
        fused = fused_object_features(img, lab, MAX_CELLS, n_rings=4)
        model, tiles = family_model_and_tiles(img_np, d, n_tiles=2)
        with full_f32():
            res = {k: family_outputs(k, fn())
                   for k, fn in family_calls(img, lab, fused, model, tiles).items()}
        res["cp_ring_wedge"] = {"": cp_ring_wedge(lab, MAX_CELLS, 4, 64)}
        out[str(d)] = res
    card, cpu = out[str(dev)], out["cpu"]
    area = cpu["shape_features"]["Area"].double().numpy()
    side = np.full_like(area, float(corner))
    exact_fns = ("object_glcm", "object_glcm_scatter", "quantile_intensity_features",
                 "dense_rank_images", "otsu_threshold", "cp_ring_wedge")
    family = {"intensity_features": "intensity", "shape_features": "shape",
              "zernike_features": "zernike", "correlation_features": "corr",
              "edge_intensity_features": "edge", "radial_distribution_features": "radial"}
    lab_c = torch.as_tensor(lab_np)
    seg = torch.where((lab_c > 0) & (lab_c < MAX_CELLS), lab_c, 0).reshape(len(lab_np), -1)
    v_in = (torch.as_tensor(img_np[..., 0]).double() * (lab_c > 0)).reshape(len(lab_np), -1)
    worst, ill = {}, {}
    for fn_name, res in card.items():
        for key, g in res.items():
            c = cpu[fn_name][key].double()
            g = g.double().cpu()
            col = ORACLE_COLUMN[family[fn_name]].format(key) if fn_name in family else ""
            if any(t in col for t in ILL_CONDITIONED):
                # as check_small_against_cpu: small differences of large sums
                # (odd moments of round cells); held against the fused
                # measurement on the card above
                ill[f"{fn_name} {key}"] = float((g - c).abs().max())
                continue
            if fn_name in exact_fns or key.startswith(FAMILY_EXACT) or key in ("count", "min", "max"):
                if not torch.equal(g, c):
                    raise AssertionError(f"family API {fn_name} {key}: card differs from CPU")
                worst.setdefault(fn_name, 0.0)
                continue
            if fn_name == "segment_stats":
                vals = v_in if key == "sum" else v_in * v_in
                scale = FAMILY_SUM_RTOL * torch.stack([
                    torch.bincount(seg[i], vals[i].abs(), minlength=MAX_CELLS)
                    for i in range(len(seg))]) + 1e-6
            elif fn_name == "radial_power_spectrum":
                scale = RPS_RTOL * c.abs() + 1e-6 * float(c.abs().max())
            elif fn_name == "segment_tiles":
                scale = torch.full_like(c, TILES_ATOL * float(c.abs().max()))
            elif key == "StdIntensityEdge":
                g, c = g * g, c * c
                scale = torch.as_tensor(oracle_tolerance("edge", "Std", c.numpy(), area, side,
                                                         corner, corner)
                                        + _edge_var_tol(cpu[fn_name]["MeanIntensityEdge"],
                                                        cpu[fn_name][key]))
            else:
                scale = torch.as_tensor(oracle_tolerance(family[fn_name], key, c.numpy(), area,
                                                         side, corner, corner))
            ratio = float(((g - c).abs() / scale).max())
            worst[fn_name] = max(worst.get(fn_name, 0.0), ratio)
            if ratio > 1.0:
                raise AssertionError(f"family API {fn_name} {key}: card vs CPU {ratio:.3g} of the "
                                     f"tolerance")
    log(f"family API {corner}² corners, card vs CPU: worst ratio to the tolerance by function "
        f"{worst} (0 = exact); ill-conditioned columns, largest difference {ill}")
    return worst


def hold_family_kernels(runs: dict, dev, entry) -> dict:
    """K1, K2, K3 and K6 at each per-family function's first inputs to
    them: held against the plain forms (exactly, K3 to SUM_RTOL with its
    count lane exact, ``hold_k3_site``), timed, and written as kernel rows
    ``<kernel>[<function>]``. Returns {row: launches in the function's
    run}."""
    from types import SimpleNamespace

    rows = {}
    for fn_name, (launches, rec) in runs.items():
        for kernel, args in rec.inputs.items():
            name = f"{kernel}[{fn_name}]"
            n = launches.get(kernel, 0)
            if kernel == "seg_counts":
                lab, codes, sizes, mc = args
                hold_k1_site(name, lab, codes, sizes, mc, dev, entry)
            elif kernel == "seg_sums":
                lab, val, mc = args
                site = SimpleNamespace(inputs={fn_name: (lab, val, mc)}, calls={fn_name: n})
                hold_k3_site(site, fn_name, name, dev, entry, count_lane=0)
            elif kernel == "seg_take_t":
                hold_k2_site(name, *args, dev, entry)
            elif kernel == "seg_pick2":
                hold_k6_site(name, *args, dev, entry)
            rows[name] = n
    return rows


def hold_k2_site(name, table, seg, mc, dev, entry):
    """K2 on one call site's inputs (a (B, max_cells, K) table, (B, N)
    labels), exactly against the plain form, timed beside one
    ``table[site, seg]``; the bound: the table and the labels read, the
    (K, N) rows written."""
    import torch

    from saguaro_tpu_torch.kernels import segment_cuda as sc

    b, n = seg.shape
    k = table.shape[2]
    if not torch.equal(sc.seg_take_t(table, seg, mc), sc.take_t_plain(table, seg, mc)):
        raise AssertionError(f"K2 {name} differs from the plain form")
    site = torch.arange(b, device=dev)[:, None]
    seg_l = seg.long()
    entry(name, "saguaro_tpu_torch/csrc/take.cu", f"{PALLAS}:383", 0.0,
          lambda: sc.seg_take_t(table, seg, mc), lambda: sc.take_t_plain(table, seg, mc),
          n_bytes=4.0 * b * (mc * k + n + k * n), n_ops=0.0, library=lambda: table[site, seg_l])


def hold_k6_site(name, hi, lo, tables, dev, entry, bare=None):
    """K6 on one call site's inputs, exactly against the plain form, timed
    (and, given its ``bare`` C call, timed bare) beside one advanced-index
    read of the flat tables; the bound: each item's two codes read and its
    K picks written, the tables read once."""
    import torch

    from saguaro_tpu_torch.kernels import segment_cuda as sc

    b, n, n_ch = hi.shape
    k = tables.shape[4]
    if not torch.equal(sc.seg_pick2(hi, lo, tables), sc.pick2_plain(hi, lo, tables)):
        raise AssertionError(f"K6 {name} differs from the plain form")
    flat_t = tables.view(b, n_ch, 65536, k)
    p_idx = hi.long() * 256 + lo.long()
    site = torch.arange(b, device=dev)[:, None, None]
    chan = torch.arange(n_ch, device=dev)[None, None, :]
    entry(name, "saguaro_tpu_torch/csrc/pick2.cu", f"{PALLAS}:824", 0.0,
          lambda: sc.seg_pick2(hi, lo, tables), lambda: sc.pick2_plain(hi, lo, tables),
          n_bytes=b * n * n_ch * (8.0 + 4.0 * k) + 4.0 * tables.numel(), n_ops=0.0,
          library=lambda: flat_t[site, chan, p_idx], bare=bare)


def compare_tables(got, want, what: str) -> float:
    """Same tables, columns and rows; every well-conditioned numeric column
    within 1e-4 of its scale (``check_small_against_cpu``'s criterion).
    Returns the worst column-relative difference."""
    worst = 0.0
    for a, c in zip(got, want, strict=True):
        for name in c:
            if list(a[name].columns) != list(c[name].columns) or len(a[name]) != len(c[name]):
                raise AssertionError(f"{what}: {name} tables differ in shape")
            cols = [k for k in c[name].select_dtypes("number").columns
                    if not any(t in k for t in ILL_CONDITIONED)]
            x = a[name][cols].to_numpy(np.float64)
            y = c[name][cols].to_numpy(np.float64)
            scale = np.abs(y).max(axis=0, keepdims=True) + 1e-12
            worst = max(worst, float((np.abs(x - y) / scale).max(initial=0.0)))
    if worst > 1e-4:
        raise AssertionError(f"{what}: tables differ by {worst:.3g} of a column's scale")
    return worst


class ShardLaunches:
    """Wraps the measurement's per-device dispatch (``features._dispatch_on``,
    once a shard of a sharded batch, once for an unsharded one) while
    active: each call's own launch counts, from ``LAUNCHES`` before and
    after it (the dispatch waits on the device where a fixpoint loop tests
    convergence, and every wrapper counts when it launches)."""

    def __enter__(self):
        from saguaro_tpu_torch.kernels import segment_cuda as sc
        from saguaro_tpu_torch.pipeline import features

        self.features, self.launches = features, []
        real = self.real = features._dispatch_on

        def counted(*args, **kw):
            before = dict(sc.LAUNCHES)
            out = real(*args, **kw)
            self.launches.append({k: v - before[k] for k, v in sc.LAUNCHES.items()})
            return out

        features._dispatch_on = counted
        return self

    def __exit__(self, *exc):
        self.features._dispatch_on = self.real


def check_shard_launches(shards: list, total: dict, n_data: int, kernels) -> None:
    """A sharded measurement's launches: one dispatch a data device, each
    launching every kernel of ``kernels`` at least once, and the shards'
    counts adding up to ``total``, read just after the run."""
    if len(shards) != n_data:
        raise AssertionError(f"the sharded measurement dispatched {len(shards)} shards, not {n_data}")
    for i, got in enumerate(shards):
        missing = [k for k in kernels if got[k] < 1]
        if missing:
            raise AssertionError(f"shard {i} of the sharded measurement did not launch {missing}: "
                                 f"{got}")
    summed = {k: sum(g[k] for g in shards) for k in total}
    if summed != total:
        raise AssertionError(f"the shards' launches {shards} do not add up to the run's {total}")
    log(f"sharded measurement launches by shard: {shards}")


def run_mesh_phase(images, gt, rec, tables, dev, measure_kernels, cfg=None) -> dict:
    """Site-batch sharding on a 2-way mesh of the one card
    (``make_mesh(devices=[cuda:0, cuda:0])``: every sharded code path, the
    shards one after another), engines at ``cfg`` (default: the full-width
    engine) with ``gradient_cpnet``'s CPnet: ``segment_batch`` of as many
    cone sites (``cone_sites``, whose nuclei that CPnet finds) as the main
    path has sites and of one fewer (padded), labels equal to the
    unsharded engine's; the measurement of the main path's sites sharded
    (4 a shard) and of one fewer (unsharded: 2 does not divide 7) against
    the main path's tables, K1-K6 launched by every shard of the sharded
    run (``check_shard_launches``); the pooled embed of 2 sites
    sharded against unsharded (the same chunks of crops: max |difference|
    within 1e-3 of the features' scale); 3 f32 steps of a small CPnet
    (TF32 off) with and without the mesh within MESH_LOSS_RTOL; and
    ``default_mesh()`` None on one card."""
    import torch

    from saguaro_tpu_torch.device import full_f32
    from saguaro_tpu_torch.kernels import segment_cuda as sc
    from saguaro_tpu_torch.models.cellpose import CellposeConfig
    from saguaro_tpu_torch.models.cellpose_train import masks_to_flows, synthetic_nuclei, train_cellpose
    from saguaro_tpu_torch.parallel.mesh import default_mesh, make_mesh
    from saguaro_tpu_torch.pipeline.features import measure_site_batch
    from saguaro_tpu_torch.pipeline.segment_embed import SegmentEmbedConfig, SegmentEmbedEngine

    if default_mesh() is not None:
        raise AssertionError("default_mesh() on one card must be None")
    mesh = make_mesh(devices=[dev, dev])
    cfg = cfg or SegmentEmbedConfig(channels=list(CHANNELS), diameter=100.0)
    cpnet = gradient_cpnet(cfg.cellpose)
    single = SegmentEmbedEngine(cfg, cellpose_state_dict=cpnet, seed=0, device=dev)
    sharded = SegmentEmbedEngine(cfg, cellpose_state_dict=cpnet, seed=0, mesh=mesh)
    cones, _ = cone_sites(len(images), images.shape[1], seed=23)
    out: dict = {}
    for n in (len(images), len(images) - 1):
        want = [x.cpu().numpy() for x in single.segment_batch(cones[:n])]
        sync(dev)
        t0 = time.perf_counter()
        got = [x.cpu().numpy() for x in sharded.segment_batch(cones[:n])]
        out[f"segment_{n}_s_per_site"] = (time.perf_counter() - t0) / n
        out[f"segment_{n}_objects"] = [int(w.max()) for w in want]
        if len(got) != n or any(not np.array_equal(a, w) for a, w in zip(got, want)):
            diff = [int((a != w).sum()) for a, w in zip(got, want)]
            raise AssertionError(f"sharded segment_batch of {n} sites differs from unsharded at "
                                 f"{diff} pixels")
        if min(out[f"segment_{n}_objects"]) < 1:
            raise AssertionError(f"segment_batch found no nuclei: {out[f'segment_{n}_objects']}")
    labels = np.stack(rec)
    for n in (len(images), len(images) - 1):
        sharded_run = n % mesh.shape["data"] == 0
        sync(dev)
        sc.reset_launch_counts()
        t0 = time.perf_counter()
        with ShardLaunches() as shards:
            got = measure_site_batch(images[:n], labels[:n], feature_config(), device=dev,
                                     mesh=mesh)
            sync(dev)
        out[f"measure_{n}_s_per_site"] = (time.perf_counter() - t0) / n
        launches = dict(sc.LAUNCHES)
        if sharded_run:
            check_shard_launches(shards.launches, launches, mesh.shape["data"], measure_kernels)
            out["launches"], out["shard_launches"] = launches, shards.launches
        out[f"measure_{n}_worst"] = compare_tables(got, tables[:n], f"sharded measurement of {n}")

    want = single.embed_sites_pooled(images[:2], list(gt[:2]))
    t0 = time.perf_counter()
    got = sharded.embed_sites_pooled(images[:2], list(gt[:2]))
    out["embed_2_s"] = time.perf_counter() - t0
    emb_err = emb_scale = 0.0
    for (wf, wc), (gf, gc) in zip(want, got, strict=True):
        if not np.array_equal(wc, gc) or wf.shape != gf.shape or len(wf) == 0:
            raise AssertionError("sharded pooled embed: other (or no) cells than unsharded")
        emb_err = max(emb_err, float(np.abs(gf - wf).max()))
        emb_scale = max(emb_scale, float(np.abs(wf).max()))
    out["embed_max_abs_diff"], out["embed_scale"] = emb_err, emb_scale
    if emb_err > 1e-3 * emb_scale:
        raise AssertionError(f"sharded pooled embed differs from unsharded by {emb_err:.3g} "
                             f"(scale {emb_scale:.3g})")
    del single, sharded

    rng = np.random.default_rng(53)
    data = [[], [], []]
    for _ in range(8):
        img, lab = synthetic_nuclei(rng, size=64, n_cells=4)
        data[0].append(img)
        data[1].append(masks_to_flows(lab, device=dev))
        data[2].append((lab > 0).astype(np.float32))
    data = [np.stack(d) for d in data]
    ccfg = CellposeConfig(tile=64, features=(8, 16, 32, 64), compute_dtype="float32")
    kw = dict(n_steps=3, batch_size=4, learning_rate=1e-3, seed=0)
    with full_f32():
        one = train_cellpose(*data, ccfg, device=dev, **kw)
        two = train_cellpose(*data, ccfg, mesh=mesh, **kw)
    loss_rel = float(np.max(np.abs(np.subtract(two.losses, one.losses)) / np.abs(one.losses)))
    if loss_rel > MESH_LOSS_RTOL:
        raise AssertionError(f"training with the mesh differs by {loss_rel:.3g} relative loss")
    out["train_loss_rel"] = loss_rel
    log(f"mesh (2 entries of one card): {json.dumps(out)}; segment labels equal, pooled embed "
        f"equal, losses {one.losses} vs {two.losses}")
    return out


# --------------------------------------------------------------------------
# The feature-extraction job grid, the profile-and-hits tail, the TIFF decoder


def write_grid_plate(root: str, n_sites: int, size: int, times, seed: int = 21) -> dict:
    """The job grid's input: for each time a job of ``n_sites`` wells of one
    site of ``cone_sites``, written as LZW TIFFs under
    ``root/in/P1_<time>/Images`` with a LoadData CSV carrying the
    platemap's compound and concentration (every fourth well DMSO), and the
    platemap at ``root/out/Plate_P1_PlateMap.csv`` for the profile stages.
    Returns {time: (n_sites, n, 2) nucleus centres (y, x)}."""
    import pandas as pd

    from saguaro_tpu_torch.io import tiff
    from tests.torch_data import platemap_frame

    platemap = platemap_frame("P1", n_sites, dmso_every=4)
    os.makedirs(os.path.join(root, "out"), exist_ok=True)
    platemap.to_csv(os.path.join(root, "out", "Plate_P1_PlateMap.csv"), index=False)
    centres = {}
    for k, t in enumerate(times):
        images, centres[t] = cone_sites(n_sites, size, seed=seed + k)
        job = os.path.join(root, "in", f"P1_{t}")
        os.makedirs(os.path.join(job, "Images"))
        rows = []
        for s, pm in platemap.iterrows():
            row = {"Metadata_Plate": "P1", "Metadata_Well": pm["Metadata_Well"], "Metadata_Site": 1,
                   "Metadata_Timepoint": t, "Metadata_Compound": pm["Metadata_Compound"],
                   "Metadata_ConcLevel": pm["Metadata_ConcLevel"]}
            for c, ch in enumerate(CHANNELS):
                name = f"{pm['Metadata_Well']}_s1_{ch}.tiff"
                tiff.imwrite(os.path.join(job, "Images", name), images[s, ..., c], compression="lzw")
                row[f"FileName_{ch}"] = name
            rows.append(row)
        pd.DataFrame(rows).to_csv(os.path.join(job, "load_data.csv"), index=False)
    return centres


def grid_engine(dev):
    """The full-width segmentation engine with ``gradient_cpnet``'s CPnet,
    which finds the cone nuclei."""
    from saguaro_tpu_torch.models.cellpose import CellposeConfig
    from saguaro_tpu_torch.pipeline.segment_embed import SegmentEmbedConfig, SegmentEmbedEngine

    return SegmentEmbedEngine(SegmentEmbedConfig(channels=list(CHANNELS)),
                              cellpose_state_dict=gradient_cpnet(CellposeConfig()), seed=0, device=dev)


def run_grid_jobs(root: str, engine, dev, times, out: str = "out", timer=None) -> dict:
    """``run_batch_processing`` over plate P1 x ``times`` of
    ``write_grid_plate``'s input, outputs under ``root/<out>``."""
    from saguaro_tpu_torch.pipeline.feature_extraction import run_batch_processing

    return run_batch_processing(
        os.path.join(root, "in"), os.path.join(root, out), ["P1"], list(times), list(CHANNELS),
        image_path_for_job=lambda p, t: f"{p}_{t}/Images",
        load_data_key_for_job=lambda p, t: f"{p}_{t}/load_data.csv",
        segmenter=engine, feature_cfg=feature_config(), device=dev, timer=timer)


def run_grid(root: str, dev, n_sites: int = 16, size: int = SIZE, times=("6", "24"),
             profile: bool = False, engine=None) -> dict:
    """The job grid at full width: ``run_batch_processing`` over 1 plate x
    ``times`` jobs of ``n_sites`` sites (LZW TIFFs of ``cone_sites``; two
    batches of 8 a job, the job's default, so a batch is finalized while
    the next one runs) with the full-width engine (``gradient_cpnet``).
    Each job wrote its four CSVs, with every placed nucleus found in every
    site (a Nuclei row centred within 3 px of it), at most
    ``GRID_EXTRA_SHARE`` of the placed count in objects beyond them (each
    logged with its area and distance), the site with the most such objects
    segmented alike on the card and the CPU (``witness_grid_site``), and no
    site failure; a second call skips both jobs from the manifest and
    writes nothing. Logs sites/s and the wall time split into
    TIFF read (with the share of the files that the native decoder
    covers), segment, dispatch, finalize and CSV writing; with
    ``profile``, one job more (into another output directory) under
    torch.profiler gives the device-busy share.
    ``engine`` defaults to ``grid_engine``'s. Returns the numbers logged."""
    import pandas as pd

    from saguaro_tpu_torch.io import fast_tiff
    from saguaro_tpu_torch.utils.timing import StageTimer

    centres = write_grid_plate(root, n_sites, size, times)
    tiffs = [os.path.join(d, f) for d, _, fs in os.walk(os.path.join(root, "in")) for f in fs
             if f.endswith(".tiff")]
    native = sum(fast_tiff.probe(Path(f).read_bytes()) is not None for f in tiffs)
    engine = engine or grid_engine(dev)
    errors = ErrorLog()
    logging.getLogger("saguaro_tpu_torch.feature_extraction").addHandler(errors)
    try:
        timer = StageTimer()
        t0 = time.perf_counter()
        written = run_grid_jobs(root, engine, dev, times, timer=timer)
        wall = time.perf_counter() - t0
        if sorted(written) != [("P1", t) for t in sorted(times)]:
            raise AssertionError(f"the grid ran jobs {sorted(written)}")
        found, extras = {}, {}
        allowed = int(GRID_EXTRA_SHARE * centres[times[0]].shape[1])
        for (_, t), files in written.items():
            if sorted(files) != ["Cells", "Cytoplasm", "Image", "Nuclei"]:
                raise AssertionError(f"job {t} wrote {sorted(files)}")
            nuclei = pd.read_csv(files["Nuclei"])
            found[t] = nuclei.groupby("ImageNumber").size().reindex(range(1, n_sites + 1),
                                                                    fill_value=0).tolist()
            if 0 in found[t]:
                raise AssertionError(f"job {t}: a site without nuclei: {found[t]}")
            for s, site in nuclei.groupby("ImageNumber"):
                yx = site[["Location_Center_Y", "Location_Center_X"]].to_numpy()
                near = np.hypot(*(centres[t][s - 1][:, None, :] - yx[None]).transpose(2, 0, 1))
                missed = int((near.min(axis=1) > 3.0).sum())
                if missed:
                    raise AssertionError(f"job {t} site {s}: {missed} placed nuclei not found")
                # objects no placed nucleus found: their area and how far they
                # lie from the nearest placed centre
                extra = np.setdiff1d(np.arange(len(yx)), near.argmin(axis=1))
                extras[(t, s)] = [(int(site["AreaShape_Area"].iloc[e]), round(float(near[:, e].min()), 1))
                                  for e in extra]
                if len(extra) > allowed:
                    raise AssertionError(f"job {t} site {s}: {len(extra)} objects beyond the placed "
                                         f"nuclei, more than {allowed}: {extras[(t, s)]}")
        extra_list = {f"{t}/{s}": e for (t, s), e in extras.items() if e}
        log("job grid: objects beyond the placed nuclei (area px, px to the nearest placed centre) "
            + json.dumps(extra_list))
        witness = witness_grid_site(root, engine, dev, max(extras, key=lambda k: len(extras[k])),
                                    found)
        if errors.messages:
            raise AssertionError(f"the grid recorded site failures: {errors.messages}")
        stamps = {f: os.path.getmtime(f) for files in written.values() for f in files.values()}
        if run_grid_jobs(root, engine, dev, times) != {} or \
                {f: os.path.getmtime(f) for f in stamps} != stamps:
            raise AssertionError("the resumed grid ran a job again")
        busy_share = None
        if profile:
            from torch.autograd import DeviceType
            from torch.profiler import ProfilerActivity, profile as trace

            with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t1 = time.perf_counter()
                run_grid_jobs(root, engine, dev, times[:1], out="out_profiled")
                traced = time.perf_counter() - t1
            busy = sum(e.self_device_time_total for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA and not e.key.startswith("measure/")) / 1e6
            busy_share = busy / traced
            log(f"profile grid, one job of {n_sites} sites: {traced:.4f} s traced, device busy "
                f"{busy:.4f} s ({100 * busy_share:.1f} %)")
    finally:
        logging.getLogger("saguaro_tpu_torch.feature_extraction").removeHandler(errors)
    n = n_sites * len(times)
    split = {k: round(v, 4) for k, v in timer.total.items()}
    split["other"] = round(wall - sum(timer.total.values()), 4)
    placed = centres[times[0]].shape[1]
    log(f"job grid: {len(times)} jobs x {n_sites} sites of {size}^2 x {len(CHANNELS)} in {wall:.4f} s, "
        f"{n / wall:.4f} sites/s; all {placed} placed nuclei found in every site, objects a site "
        f"{json.dumps(found)}; split (s) {json.dumps(split)}; native TIFF decoder covers {native} "
        f"of {len(tiffs)} files; the resume ran no job")
    return {"sites_per_s": n / wall, "wall_s": wall, "split_s": split, "native_files": native,
            "files": len(tiffs), "device_busy_share": busy_share, "placed": placed, "found": found,
            "extras": extra_list, "witness": witness}


def witness_grid_site(root: str, engine, dev, site: tuple, found: dict) -> dict:
    """Segment grid site ``site`` = (time, ImageNumber) from its TIFFs as
    the job does (``segment_batch``: pointer-jumping mask recovery) with
    ``engine`` on the card and with an engine of its config and CPnet
    weights on the CPU: the card finds the objects the job found there, and
    the CPU the same objects (as many, each centroid within 1 px of one of
    the card's), so objects beyond the placed nuclei are the segmentation's
    own on both devices. Also logs what the single-site path (``segment``:
    Euler recovery) finds on the card. Returns the counts and the pixels
    whose foreground differs."""
    import pandas as pd
    from scipy import ndimage

    from saguaro_tpu_torch.io import tiff
    from saguaro_tpu_torch.pipeline.segment_embed import SegmentEmbedEngine

    t, s = site
    job = os.path.join(root, "in", f"P1_{t}")
    row = pd.read_csv(os.path.join(job, "load_data.csv")).iloc[s - 1]
    image = np.stack([np.asarray(tiff.imread(os.path.join(job, "Images", row[f"FileName_{ch}"])))
                      for ch in CHANNELS], axis=-1)
    cpu_engine = SegmentEmbedEngine(engine.cfg, cellpose_state_dict={
        k: v.cpu() for k, v in engine.cell_model.state_dict().items()}, device="cpu")
    on_card = engine.segment_batch(image[None])[0].cpu().numpy()
    on_cpu = cpu_engine.segment_batch(image[None])[0].numpy()
    euler = int(engine.segment(image).max())

    def centroids(lab):
        return np.array(ndimage.center_of_mass(lab > 0, lab, np.arange(1, lab.max() + 1)))

    card, cpu = centroids(on_card), centroids(on_cpu)
    differ = int(((on_card > 0) != (on_cpu > 0)).sum())
    apart = np.hypot(*(card[:, None, :] - cpu[None]).transpose(2, 0, 1)).min(axis=1)
    log(f"grid site {t}/{s}: the job found {found[t][s - 1]} objects; segment_batch finds "
        f"{len(card)} on the card and {len(cpu)} on the CPU (centroids within {apart.max():.3f} px, "
        f"foreground differs at {differ} pixels); segment (Euler) on the card {euler}")
    if len(card) != found[t][s - 1] or len(cpu) != len(card) or apart.max() > 1.0:
        from saguaro_tpu_torch.device import full_f32

        with full_f32():
            f32 = int(engine.segment_batch(image[None])[0].max())
        raise AssertionError(f"grid site {t}/{s}: the card's and the CPU's segmentation differ "
                             f"(on the card without TF32: {f32} objects)")
    return {"site": f"{t}/{s}", "objects": len(card), "euler_objects": euler,
            "centroid_px": float(apart.max()), "foreground_px_differ": differ}


def run_profile_chain(root: str, times, out: str, dev) -> dict:
    """The five profile CLIs (``tests.torch_data.profile_cli_args``) over
    the CP tables under ``root`` with ``--device dev``; returns seconds a
    stage. Hit calling and its CSV run first; where matplotlib or seaborn
    is not installed the plots raise ``ModuleNotFoundError``, which is
    logged as such."""
    import importlib

    from tests.torch_data import profile_cli_args

    secs = {}
    for name, argv in profile_cli_args(root, "P1", list(times), out):
        main = importlib.import_module(f"saguaro_tpu_torch.cli.{name}").main
        t0 = time.perf_counter()
        try:
            main(argv + ["--device", str(dev)])
        except ModuleNotFoundError as e:
            if name != "induction_hit" or e.name not in ("matplotlib", "seaborn"):
                raise
            log(f"{name} on {dev}: hit calling and Bioactivities_per_plate_doses.csv done; the "
                f"plots were not drawn: {e.name} is not installed on this machine")
        secs[name] = time.perf_counter() - t0
    if not os.path.exists(os.path.join(root, out, "hits", "Bioactivities_per_plate_doses.csv")):
        raise AssertionError(f"{out}: no Bioactivities CSV")
    return secs


def selection_ties(root: str, out: str) -> tuple[int, int, int]:
    """(kept feature columns, feature columns entering selection, pairs of
    identical columns with one member kept) of ``run_profile_chain``'s run
    into ``root/out``: the ties that the f32 rank sums break (the port
    computes them as the reference does)."""
    import pandas as pd

    norm_dir = os.path.join(root, out, "normalized")
    normalized = pd.concat([pd.read_csv(os.path.join(d, f)) for d, _, fs in os.walk(norm_dir)
                            for f in sorted(fs) if f.endswith(".csv")], ignore_index=True)
    features = [c for c in normalized.columns if "Metadata" not in c]
    raw = os.path.join(root, out, "selected", "Exp_CP_features_selected_allTimes_raw.csv")
    kept = {c for c in pd.read_csv(raw, nrows=0).columns if "Metadata" not in c}
    groups: dict[bytes, list[str]] = {}
    for c in features:
        groups.setdefault(normalized[c].to_numpy("float64").tobytes(), []).append(c)
    ties = sum(1 for g in groups.values() for i, a in enumerate(g) for b in g[i + 1:]
               if (a in kept) != (b in kept))
    return len(kept), len(features), ties


def hold_profile_chain(root: str, times, dev, label: str) -> dict:
    """``run_profile_chain`` on the card and on the CPU over the same
    files: the same output files, and every CSV the same table (columns,
    shape, numbers within ``tests.torch_data.assert_csv_close``'s 1e-5).
    Returns seconds a stage on the card and on the CPU, and the tables'
    count and shapes."""
    from tests.torch_data import assert_csv_close

    on_card = run_profile_chain(root, times, "chain_card", dev)
    on_cpu = run_profile_chain(root, times, "chain_cpu", "cpu")
    files = [sorted(os.path.relpath(os.path.join(d, f), os.path.join(root, out))
                    for d, _, fs in os.walk(os.path.join(root, out)) for f in fs if f.endswith(".csv"))
             for out in ("chain_card", "chain_cpu")]
    if files[0] != files[1] or not files[0]:
        raise AssertionError(f"{label}: the card wrote {files[0]}, the CPU {files[1]}")
    shapes = {f: assert_csv_close(os.path.join(root, "chain_card", f), os.path.join(root, "chain_cpu", f))
              for f in files[0]}
    log(f"profile chain {label}: {len(shapes)} CSVs, card = CPU within 1e-5; seconds on the card "
        + json.dumps({k: round(v, 4) for k, v in on_card.items()}) + ", on the CPU "
        + json.dumps({k: round(v, 4) for k, v in on_cpu.items()}) + "; shapes "
        + json.dumps({os.path.basename(k): v for k, v in shapes.items()}))
    kept, n_features, ties = selection_ties(root, "chain_card")
    log(f"feature selection {label}: {kept} of {n_features} columns kept, the card's and the "
        f"CPU's the same; {ties} ties of identical columns resolved by the reference's f32 rank sums")
    return {"card_s": on_card, "cpu_s": on_cpu, "csvs": len(shapes), "kept": kept, "ties": ties}


def run_profile_phase(grid_root: str, dev, times=("6", "24"), n_wells: int = 384,
                      plate_times=("6", "12", "24", "48"), cells: int = PLATE_CELLS,
                      seed: int = 31) -> dict:
    """The profile-and-hits tail on the card: first on the job grid's own
    CSVs (``grid_root/out``), then on a plate of ``n_wells`` wells x
    ``plate_times`` (``tests.torch_data.write_cp_plate``: the four tables a
    well with the column set the job's measurement wrote, ``cells`` objects
    a well, values from the seed, a platemap of compounds and DMSO wells);
    each held card against CPU (``hold_profile_chain``)."""
    import pandas as pd

    from tests.torch_data import write_cp_plate

    out = {"job": hold_profile_chain(os.path.join(grid_root, "out"), times, dev, "on the job's CSVs")}
    job = os.path.join(grid_root, "out", "P1", times[0])
    columns = {name: list(pd.read_csv(os.path.join(job, f"{name}.csv"), nrows=0).columns)
               for name in ("Image", "Nuclei", "Cells", "Cytoplasm")}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        write_cp_plate(root, "P1", list(plate_times), n_wells, columns, seed=seed, cells=cells,
                       workers=len(plate_times))
        log(f"profile plate: {n_wells} wells x {len(plate_times)} timepoints, {cells} objects a "
            f"well, columns "
            + json.dumps({k: len(v) for k, v in columns.items()})
            + f", written in {time.perf_counter() - t0:.1f} s")
        out["plate"] = hold_profile_chain(root, plate_times, dev, f"at {n_wells} wells")
    return out


def run_tiff_phase(dev, n: int = 16, size: int = RAW, seed: int = 41, workers: int = 8) -> dict:
    """The TIFF decoder on ``n`` raw ``size``² uint16 fields, written
    uncompressed and LZW: the native decoder one after another and on the
    segment-embed prefetch pool (``workers`` threads), and PIL one after
    another; every decode equal to the field. Returns ms/image of each."""
    import io
    import queue

    from PIL import Image

    from saguaro_tpu_torch.io import fast_tiff, tiff
    from saguaro_tpu_torch.pipeline.segment_embed import _prefetch_sites

    rng = np.random.default_rng(seed)
    fields = rng.integers(0, 4096, (n, size, size)).astype(np.uint16)
    fields += synthetic_sites(1, size, seed)[0][0, ..., 0]
    out = {}
    with tempfile.TemporaryDirectory() as root:
        for comp in (None, "lzw"):
            tag = comp or "raw"
            paths = []
            for k in range(n):
                paths.append(os.path.join(root, f"{tag}_{k}.tiff"))
                tiff.imwrite(paths[-1], fields[k], compression=comp)
            blobs = [Path(p).read_bytes() for p in paths]
            if any(fast_tiff.probe(b) is None for b in blobs):
                raise AssertionError(f"{tag}: the native decoder does not cover the written files")
            t0 = time.perf_counter()
            native = [fast_tiff.decode(b) for b in blobs]
            out[f"native_{tag}_ms"] = 1e3 * (time.perf_counter() - t0) / n
            t0 = time.perf_counter()
            pil = []
            for b in blobs:
                with Image.open(io.BytesIO(b)) as im:
                    pil.append(np.asarray(im))
            out[f"pil_{tag}_ms"] = 1e3 * (time.perf_counter() - t0) / n
            q: queue.Queue = queue.Queue()
            t0 = time.perf_counter()
            _prefetch_sites([(k, [p]) for k, p in enumerate(paths)], None, workers, q)
            pooled = dict(q.get(timeout=300) for _ in range(n))
            out[f"native_{tag}_pool_ms"] = 1e3 * (time.perf_counter() - t0) / n
            for k in range(n):
                if not (np.array_equal(native[k], fields[k]) and np.array_equal(pil[k], fields[k])
                        and pooled[k] is not None and np.array_equal(pooled[k][..., 0], fields[k])):
                    raise AssertionError(f"{tag} field {k}: the native, PIL and pool decodes differ")
    log(f"TIFF decode of {n} fields of {size}^2 uint16 (ms/image; the pool's {workers} threads "
        "include the f32 conversion): " + json.dumps({k: round(v, 3) for k, v in out.items()})
        + "; native = PIL = the field, bit for bit")
    return out


# --------------------------------------------------------------------------
# Embed stage: masked crops into EfficientNetV2-L, dead-cell scoring, and the
# segment-embed pipeline through its CLI


def expected_cells(gt, box: int = BOX):
    """Per site of ground-truth labels (B, H, W), the ids and (cy, cx) of the
    cells the reference's edge rule keeps, in label order: centroids as the
    floor of the f32 quotient of the exact coordinate sums and the count."""
    h, w = gt.shape[1:]
    yy, xx = np.mgrid[:h, :w]
    half = box // 2
    out = []
    for lab in gt:
        flat = lab.ravel()
        n = int(flat.max()) + 1
        cnt = np.bincount(flat, minlength=n)
        cnt[0] = 0
        denom = np.maximum(cnt, 1).astype(np.float32)
        cy = np.floor(np.bincount(flat, yy.ravel(), n).astype(np.float32) / denom).astype(np.int64)
        cx = np.floor(np.bincount(flat, xx.ravel(), n).astype(np.float32) / denom).astype(np.int64)
        keep = (cnt > 0) & (cy - half >= 0) & (cy + half <= h) & (cx - half >= 0) & (cx + half <= w)
        ids = np.flatnonzero(keep)
        out.append((ids, np.stack([cy[ids], cx[ids]], axis=-1)))
    return out


def effnet_cost(config, size: int, in_ch: int = 1) -> tuple[int, int]:
    """(multiply-adds, bytes) of one crop through an EffNetV2 config at
    size², walked from the config: every convolution's MACs (depthwise ones
    per group), the squeeze-excitation products, and the bytes of every
    convolution's output written once and read once in bf16 (4 B an
    element) plus the f32 input read once."""
    macs = elems = 0
    n = size

    def conv(cin, cout, k, s, groups=1):
        nonlocal n, macs, elems
        n = -(-n // s)
        macs += n * n * cout * (cin // groups) * k * k
        elems += n * n * cout

    conv(in_ch, config.stem_filters, 3, 2)
    cin = config.stem_filters
    for spec in config.stages:
        for i in range(spec.count):
            s = spec.stride if i == 0 else 1
            mid = cin * spec.expand
            if spec.block == "fused" and spec.expand == 1:
                conv(cin, spec.filters, spec.kernel, s)
            elif spec.block == "fused":
                conv(cin, mid, spec.kernel, s)
                conv(mid, spec.filters, 1, 1)
            else:
                conv(cin, mid, 1, 1)
                conv(mid, mid, spec.kernel, s, groups=mid)
                macs += 2 * mid * max(1, int(cin * spec.se_ratio))
                conv(mid, spec.filters, 1, 1)
            cin = spec.filters
    conv(cin, config.head_filters, 1, 1)
    return macs, 4 * elems + 4 * size * size * in_ch


def embed_bound(n_crops: int, config, size: int, box: int) -> tuple[float, str, float, float]:
    """The embed stage's least time on the card for ``n_crops`` crops (s):
    the larger of its bytes over the memory rate (each crop's network
    activations, ``effnet_cost``, and its box² f32 crop) and its operations
    (the network's in bf16 on the tensor cores, the two resize products'
    in f32). Returns (seconds, which bounds, bf16 FLOPs, bytes)."""
    macs, act = effnet_cost(config, size)
    flops = 2.0 * macs * n_crops
    f32_flops = 2.0 * n_crops * (box * box * size + size * box * size)
    n_bytes = float(n_crops) * (act + 4 * box * box)
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / BF16_OPS_PER_S + f32_flops / F32_OPS_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), flops, n_bytes


def path_crops(images, gt, dev, n: int, box: int = BOX):
    """The first ``n`` crop slots the engine would embed (cell-major,
    channel-minor over the sites), gathered on ``dev``: (n, box, box) f32."""
    import torch

    from saguaro_tpu_torch.kernels.crops import gather_crops

    n_ch = images.shape[-1]
    slots = [(s, k, c, y, x) for s, (ids, yx) in enumerate(expected_cells(gt, box))
             for k, (y, x) in zip(ids, yx) for c in range(n_ch)][:n]
    idx = torch.as_tensor(np.array(slots).T, device=dev)
    chw = torch.as_tensor(images, device=dev).float().permute(0, 3, 1, 2).contiguous()
    return gather_crops(chw, torch.as_tensor(gt, device=dev), *idx, box=box)


def calibrated_effnet(images, gt, dev, n: int = 32, size: int = EMBED_SIZE) -> dict:
    """An EFFNETV2_L state dict (unfolded, timm keys): convolution weights
    random from seed 0, and BatchNorm statistics those of one pass over the
    path's first ``n`` crops at ``size``² in f32 (train mode, momentum 1),
    so that every layer's activations stay of order one through the 79
    blocks. With the default statistics (identity) the largest feature is
    about 0.002 (0.44 calibrated), where a comparison of two devices or
    dtypes says little."""
    import dataclasses

    import torch

    from saguaro_tpu_torch.device import full_f32
    from saguaro_tpu_torch.models.effnetv2 import EFFNETV2_L, init_effnetv2, preprocess_crops

    model = init_effnetv2(dataclasses.replace(EFFNETV2_L, compute_dtype="float32"), seed=0, device=dev)
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = 1.0
    model.train()
    with torch.no_grad(), full_f32():
        model(preprocess_crops(path_crops(images, gt, dev, n), size, n_channels=3))
    return model.eval().state_dict()


class ErrorLog(logging.Handler):
    """Collects the messages of ERROR records (the engine's degrades)."""

    def __init__(self):
        super().__init__(logging.ERROR)
        self.messages: list[str] = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def check_embed_numerics(engine, images, gt, dev) -> dict:
    """The embedding network against itself elsewhere, on the path's first
    crops. Card against CPU: full-width L, f32 with TF32 off, the engine's
    weights, 8 crops at 128²; every feature within EMBED_CPU_RTOL of the
    features' largest magnitude. bf16 against f32 on the card: the engine's
    network and its f32 twin on the same 8 crops at the path's 480²; each
    crop's bf16 embedding nearer to its own f32 embedding than any two
    crops' f32 embeddings are to each other. Returns the measured errors."""
    import copy
    import dataclasses

    import torch

    from saguaro_tpu_torch.device import full_f32
    from saguaro_tpu_torch.models.effnetv2 import preprocess_crops

    crops = path_crops(images, gt, dev, 8)
    f32 = copy.deepcopy(engine.feat_model)
    f32.config = dataclasses.replace(f32.config, compute_dtype="float32")
    x = preprocess_crops(crops, CPU_CHECK_SIZE, n_channels=1)
    with torch.no_grad(), full_f32():
        on_card = f32(x).cpu()
        on_cpu = copy.deepcopy(f32).cpu()(x.cpu())
        x = preprocess_crops(crops, engine.cfg.embed_size, n_channels=1)
        want = f32(x)
        got = engine.feat_model(x.contiguous(memory_format=torch.channels_last))
    scale = float(on_cpu.abs().max())
    cpu_err = float((on_card - on_cpu).abs().max()) / scale
    cos = torch.nn.functional.cosine_similarity(got.float(), want, dim=1)
    unit = torch.nn.functional.normalize(want, dim=1)
    cross = (unit @ unit.T)[~torch.eye(len(unit), dtype=torch.bool, device=unit.device)]
    bf16_err = float((got.float() - want).abs().max() / want.abs().max())
    log(f"embed numerics: card vs CPU (f32, {CPU_CHECK_SIZE}^2, 8 crops) max |diff| {cpu_err:.3g} of "
        f"the features' scale {scale:.4g} (tolerance {EMBED_CPU_RTOL:g}); bf16 vs f32 on the card "
        f"(480^2) cosine {float(cos.min()):.5f}-{float(cos.max()):.5f}, two crops' f32 at "
        f"{float(cross.min()):.5f}-{float(cross.max()):.5f}, max |diff| {bf16_err:.3g} of the f32 "
        "scale")
    if not (torch.isfinite(on_card).all() and torch.isfinite(got).all()):
        raise AssertionError("non-finite embeddings in the numerics check")
    if cpu_err > EMBED_CPU_RTOL:
        raise AssertionError(f"embedding on the card differs from the CPU by {cpu_err:.3g}")
    if float(cos.min()) <= float(cross.max()):
        raise AssertionError(f"a bf16 embedding at cosine {float(cos.min()):.4f} of its f32 one, "
                             f"two crops' f32 embeddings at up to {float(cross.max()):.4f}")
    return {"card_vs_cpu": cpu_err, "bf16_cos_min": float(cos.min()),
            "f32_cross_cos_max": float(cross.max()), "bf16_vs_f32": bf16_err}


def time_memory_formats(engine, dev, chunk: int) -> dict:
    """ms of the engine's bf16 network on one chunk of (chunk, 1, 480, 480)
    inputs, its weights and input in NCHW and in channels_last (CUDA
    events, median of 5 after 2 warm-ups); the engine's own format is put
    back."""
    import torch

    from saguaro_tpu_torch.pipeline.segment_embed import EMBED_MEMORY_FORMAT

    size = engine.cfg.embed_size
    x = torch.rand((chunk, 1, size, size), device=dev) * 2 - 1
    out = {}
    with torch.no_grad():
        for name, fmt in (("channels_last", torch.channels_last), ("nchw", torch.contiguous_format)):
            engine.feat_model.to(memory_format=fmt)
            xin = x.contiguous(memory_format=fmt)
            out[name] = time_ms(lambda: engine.feat_model(xin), reps=5)
    engine.feat_model.to(memory_format=EMBED_MEMORY_FORMAT)
    log(f"embed network, one chunk of {chunk} at {size}^2 in bf16: channels_last "
        f"{out['channels_last']:.2f} ms, NCHW {out['nchw']:.2f} ms")
    return out


def run_embed(images, gt, dev) -> dict:
    """The embed stage at its defaults (EFFNETV2_L, bf16, folded BN and RGB
    stem, 480², box 200, chunks of 128) on the 8 sites with the ground
    truth's labels (the random CPnet finds none): one warm-up call, then a
    timed one (host clock to a synchronise). Every site comes back with the
    cells the edge rule keeps, at the numpy centroids, with finite
    features; no degrade is logged. Returns its numbers."""
    import torch

    from saguaro_tpu_torch.pipeline.segment_embed import SegmentEmbedConfig, SegmentEmbedEngine

    errors = ErrorLog()
    logging.getLogger("saguaro_tpu_torch.segment_embed").addHandler(errors)
    try:
        engine = SegmentEmbedEngine(SegmentEmbedConfig(channels=list(CHANNELS)),
                                    effnet_state_dict=calibrated_effnet(images, gt, dev),
                                    seed=0, device=dev)
        cfg = engine.cfg
        want = expected_cells(gt, cfg.box_size)
        n_crops = sum(len(ids) for ids, _ in want) * len(CHANNELS)
        engine.embed_sites_pooled(images, list(gt))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        got = engine.embed_sites_pooled(images, list(gt))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak_total = torch.cuda.max_memory_allocated()
        peak = peak_total - base
        for s, ((feats, coords), (_, yx)) in enumerate(zip(got, want)):
            if feats.shape != (len(yx), len(CHANNELS), 1280) or not np.array_equal(coords, yx):
                raise AssertionError(f"site {s}: {feats.shape[0]} cells at other coords than the "
                                     f"{len(yx)} the edge rule keeps")
            if not np.isfinite(feats).all():
                raise AssertionError(f"site {s}: non-finite embeddings")
        feats_dev = torch.as_tensor(np.concatenate([f for f, _ in got]), device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feats_dev.cpu()
        copy_ms = (time.perf_counter() - t0) * 1e3
        t_bound, by, flops, n_bytes = embed_bound(n_crops, cfg.effnet, cfg.embed_size, cfg.box_size)
        chunks = -(-n_crops // cfg.embed_chunk)
        log(f"embed: {len(want)} sites, {[len(y) for _, y in want]} cells, {n_crops} crops in "
            f"{chunks} chunks of {cfg.embed_chunk}: {secs:.4f} s ({secs / len(want):.4f} s/site, "
            f"{n_crops / secs:.1f} crops/s); peak {peak_total / 1e9:.3f} GB allocated, {peak / 1e9:.3f} "
            f"GB above the weights and inputs (the crop pool would be {POOL_BYTES / 1e9:.3f} GB); bound {t_bound:.4f} s ({by}: "
            f"{flops / 1e15:.4f} PFLOP bf16, {n_bytes / 1e12:.4f} TB); the embeddings' one copy "
            f"to the host {copy_ms:.2f} ms")
        numerics = check_embed_numerics(engine, images, gt, dev)
        formats = time_memory_formats(engine, dev, cfg.embed_chunk)
        if errors.messages:
            raise AssertionError(f"the embed stage degraded: {errors.messages}")
    finally:
        logging.getLogger("saguaro_tpu_torch.segment_embed").removeHandler(errors)
    return {"s_per_site": secs / len(want), "crops": n_crops, "chunks": chunks,
            "crops_per_s": n_crops / secs, "peak_gb": peak / 1e9, "bound_s_per_site": t_bound / len(want),
            "bound_by": by, "copy_ms": copy_ms, **numerics, **{f"chunk_ms_{k}": v for k, v in formats.items()}}


def cone_sites(n_sites: int, size: int, seed: int, radius: float = 20.0):
    """((B, size, size, 5) uint16 sites, (B, n, 2) nucleus centres): the
    same grid of jittered nuclei as ``synthetic_sites`` (16 x 16 at 1080²),
    each a cone of intensity (2000 at its centre, 0 at ``radius``) in every
    channel over a background of 80-120: an intensity whose gradient points
    to the centre with one magnitude everywhere inside, which
    ``gradient_cpnet`` turns into flows."""
    rng = np.random.default_rng(seed)
    images = rng.integers(80, 120, (n_sites, size, size, len(CHANNELS))).astype(np.float32)
    yy, xx = np.mgrid[-32:33, -32:33]
    cone = 2000.0 * np.maximum(0.0, 1.0 - np.hypot(yy, xx) / radius)
    centres = []
    for s in range(n_sites):
        centres.append([])
        for cy in range(60, size - 35, 64):
            for cx in range(60, size - 35, 64):
                y, x = cy + rng.integers(-3, 4), cx + rng.integers(-3, 4)
                images[s, y - 32 : y + 33, x - 32 : x + 33] += cone[..., None]
                centres[s].append((y, x))
    return images.astype(np.uint16), np.array(centres)


def gradient_cpnet(config, gain: float = 30.0, cellprob_at: float = 0.3) -> dict:
    """A CPnet state dict made without training, for the CLI phase: the
    random net's masks all fail the flow QC (flow error above 0.4), so no
    cell would reach the embed stage. Every convolution and Linear is zero
    but three: the first block's projection copies the first input channel;
    res_up_0's first style conv takes its central differences (+-d/dy,
    +-d/dx, and the value); the head turns them into flows (``gain`` times
    the gradient) and a cell probability above 0 where the normalised value
    exceeds ``cellprob_at``. On ``cone_sites`` the flows point to each
    nucleus' centre, as cellpose's own."""
    import torch

    from saguaro_tpu_torch.models.cellpose import init_cellpose

    net = init_cellpose(config, device="cpu")
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
                m.weight.zero_()
                m.bias.zero_()
        net.downsample.down.res_down_0.proj[1].weight[0, 0] = 1.0
        w = net.upsample.up.res_up_0.conv.conv_1.conv[2].weight
        w[0, 0, 1, 1] = 1.0
        for ch, sign, (a, b) in ((1, 1, (2, 1)), (2, -1, (2, 1)), (3, 1, (1, 2)), (4, -1, (1, 2))):
            w[ch, 0, a, b] = 0.5 * sign
            w[ch, 0, 2 - a, 2 - b] = -0.5 * sign
        head = net.output[2]
        head.weight[0, 1], head.weight[0, 2] = gain, -gain
        head.weight[1, 3], head.weight[1, 4] = gain, -gain
        head.weight[2, 0] = 10.0
        head.bias[2] = -10.0 * cellprob_at
    return net.state_dict()


def write_plate(root: str, images) -> str:
    """One well a site: ``A0<i>_s1_<ch>.tiff`` under ``root``/Images and a
    LoadData CSV; returns the CSV's path."""
    import pandas as pd

    from saguaro_tpu_torch.io import tiff

    os.makedirs(os.path.join(root, "Images"), exist_ok=True)
    rows = []
    for s in range(len(images)):
        row = {"Metadata_Plate": "P1", "Metadata_Well": f"A{s + 1:02}", "Metadata_Site": 1,
               "Metadata_Timepoint": "6"}
        for c, ch in enumerate(CHANNELS):
            name = f"A{s + 1:02}_s1_{ch}.tiff"
            tiff.imwrite(os.path.join(root, "Images", name), images[s, ..., c])
            row[f"FileName_{ch}"] = name
        rows.append(row)
    path = os.path.join(root, "load_data.csv")
    pd.DataFrame(rows).to_csv(path, index=False)
    return path


def run_cli(dev, n_sites: int = 2, size: int = SIZE) -> dict:
    """The segment-embed CLI (``run_pipeline``) on a temporary plate of
    ``n_sites`` ``cone_sites`` written as uint16 TIFFs, with
    ``gradient_cpnet``'s CPnet as its checkpoint file, a synthetic XGBoost
    JSON, ``--save_coords --single_cell``: its four files exist with the
    reference's columns, a site embedded cells, and nothing degraded.
    Returns seconds per site and the cells found."""
    import pandas as pd
    import torch

    from saguaro_tpu_torch.cli.segment_embed import main as segment_embed
    from saguaro_tpu_torch.models.cellpose import CellposeConfig
    from tests.torch_data import xgb_model_json

    errors = ErrorLog()
    logging.getLogger("saguaro_tpu_torch.segment_embed").addHandler(errors)
    try:
        with tempfile.TemporaryDirectory() as root:
            load_data = write_plate(root, cone_sites(n_sites, size, seed=12)[0])
            cpnet = os.path.join(root, "cpnet.pt")
            torch.save(gradient_cpnet(CellposeConfig()), cpnet)
            xgb = os.path.join(root, "xgb.json")
            with open(xgb, "w") as f:
                f.write(xgb_model_json(len(CHANNELS) * 1280, seed=1))
            t0 = time.perf_counter()
            outputs = segment_embed([
                "--bucket_input", root, "--data_base_path", os.path.join(root, "Images"),
                "--load_data_key", "load_data.csv", "--channels", *CHANNELS,
                "--out_data_path", os.path.join(root, "out", "plate.parquet"), "--save_coords",
                "--single_cell", "--xgb_model_path", xgb, "--cellpose_checkpoint", cpnet,
                "--max_workers", "4", "--device", str(dev)])
            secs = (time.perf_counter() - t0) / n_sites
            tables = {k: (pd.read_csv(v) if k == "counts" else pd.read_parquet(v))
                      for k, v in outputs.items()}
    finally:
        logging.getLogger("saguaro_tpu_torch.segment_embed").removeHandler(errors)
    base = ["Metadata_Plate", "Metadata_Well", "Metadata_Site", "Metadata_Timepoint",
            *[f"FileName_{ch}" for ch in CHANNELS]]
    want = {
        "counts": base + ["Cell_Count", "Dead_Cells"],
        "coords": ["Cell_ID", "Y_Center", "X_Center", "Is_Dead"],
        "well_aggregated": ["Metadata_Well", "Cell_Count", "Metadata_Timepoint", "Metadata_Plate",
                            "mean_features"],
        "single_cell": base + ["Dead_Cells", "Cell_Index", "single_cell_features", "is_dead_cell"],
    }
    got = {k: list(t.columns) for k, t in tables.items()}
    if got != want:
        raise AssertionError(f"the CLI wrote {got}, expected {want}")
    counts = tables["counts"]["Cell_Count"].tolist()
    if max(counts) < 1 or len(tables["coords"]) != sum(counts):
        raise AssertionError(f"the CLI embedded {counts} cells, {len(tables['coords'])} coords")
    if errors.messages:
        raise AssertionError(f"the CLI run degraded: {errors.messages}")
    log(f"segment-embed CLI: {n_sites} sites of {size}^2 x {len(CHANNELS)}, cells {counts}, dead "
        f"{tables['counts']['Dead_Cells'].tolist()}, {secs:.3f} s/site (host I/O, model builds "
        "and first calls included); four files with the reference's columns")
    return {"s_per_site": secs, "cells": counts}


# --------------------------------------------------------------------------
# Segmenter training and a checkpoint written on the card

TRAIN_PAIRS = 32            # training (image, mask) pairs
HELD_OUT = 4                # held-out pairs
TRAIN_TILE = 224            # the CLI's default tile
TRAIN_NUCLEI = 20           # synthetic_nuclei's draws a tile (overlaps are dropped)
FIELD_NUCLEI = 480          # its draws on the 1080² field: about 400 placed
TRAIN_IOU = 0.5             # tests/test_train.py:82
# 5 f32 steps (TF32 off) of a small CPnet, card against CPU from the same
# weights and batches: the losses agree to this relative tolerance. Adam's
# first steps move each weight by about the learning rate in the direction
# of its gradient's sign, so weights whose gradients are near zero, whose
# sign the summation order decides, move apart by up to twice the rate; on
# an NVIDIA H100 80GB HBM3 the third step's loss differed by 7.7e-5
TRAIN_CPU_RTOL = 1e-3


def iou_matched(gt: np.ndarray, pred: np.ndarray) -> float:
    """Mean best-match IoU over the ground truth's cells
    (tests/test_train.py's ``_iou_matched``)."""
    ious = []
    for lab in np.unique(gt[gt > 0]):
        m = gt == lab
        ids, counts = np.unique(pred[m], return_counts=True)
        ids, counts = ids[ids > 0], counts[ids > 0]
        if ids.size == 0:
            ious.append(0.0)
            continue
        p = pred == ids[np.argmax(counts)]
        ious.append(np.logical_and(m, p).sum() / np.logical_or(m, p).sum())
    return float(np.mean(ious)) if ious else 0.0


def cpnet_conv_flops(config, size: int) -> float:
    """Forward FLOPs of one image through CPnet's convolutions at size x
    size, from the config's layer shapes (2 per multiply-add; the style
    Linear layers and the elementwise work left out)."""
    nbase = [config.n_channels, *config.features]
    up = [*config.features, config.features[-1]]

    def block(cin, cout, side):  # proj 1x1, conv_0 3x3, conv_1..3 3x3
        return 2 * side * side * (cin * cout * (1 + 9) + 3 * cout * cout * 9)

    flops = sum(block(nbase[n], nbase[n + 1], size >> n) for n in range(len(config.features)))
    flops += sum(block(up[n], up[n - 1], size >> (n - 1)) for n in range(1, len(up)))
    return flops + 2 * size * size * up[0] * 3


def write_training_pairs(root: str, n: int, size: int, n_cells: int, rng) -> list:
    """``n`` pairs ``img<i>.tiff`` (channel 0 of ``synthetic_nuclei`` x 1000
    as uint16) + ``img<i>_masks.tiff`` under ``root``, as the reference's
    CLI test writes them; returns the label images."""
    from saguaro_tpu_torch.io import tiff
    from saguaro_tpu_torch.models.cellpose_train import synthetic_nuclei

    os.makedirs(root, exist_ok=True)
    labels = []
    for i in range(n):
        img, lab = synthetic_nuclei(rng, size=size, n_cells=n_cells)
        tiff.imwrite(os.path.join(root, f"img{i}.tiff"), (img[..., 0] * 1000).astype(np.uint16))
        tiff.imwrite(os.path.join(root, f"img{i}_masks.tiff"), lab.astype(np.uint16))
        labels.append(lab)
    return labels


def segment_trained(engine, images) -> tuple[list, float]:
    """``segment_batch`` on (B, H, W) uint16 images (one channel; the
    network's second is zero), warmed up once: labels and seconds a site."""
    import torch

    x = np.asarray(images)[..., None]
    engine.segment_batch(x)
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    labels = [lab.cpu().numpy() for lab in engine.segment_batch(x)]
    return labels, (time.perf_counter() - t0) / len(labels)


def run_training(dev, root: str, n_train: int = TRAIN_PAIRS, n_held: int = HELD_OUT,
                 size: int = TRAIN_TILE, steps: int = 500, batch: int = 8, field: int = SIZE,
                 field_nuclei: int = FIELD_NUCLEI, effnet=None, seed: int = 51) -> dict:
    """The segmenter trained on the card through ``train_segmenter``'s
    ``main`` at the CLI's full-width defaults (CPnet features 32-256, bf16,
    tile ``size``, batch ``batch``, ``steps`` steps, learning rate 1e-3)
    on ``n_train`` TIFF pairs of ``synthetic_nuclei``; then
    the checkpoint it wrote, loaded by a full-width engine through
    ``cellpose_checkpoint=`` (diameter = the net's diam_mean: the images
    are at the training scale), segments ``n_held`` held-out tiles and one
    ``field`` x ``field`` field with ``segment_batch`` (pointer-jumping
    recovery, flow QC). Returns the phase's numbers; ``check_training``
    holds them."""
    import torch

    from saguaro_tpu_torch.cli.train_segmenter import main as train_segmenter
    from saguaro_tpu_torch.io import tiff
    from saguaro_tpu_torch.models.cellpose import CellposeConfig
    from saguaro_tpu_torch.models.cellpose_train import synthetic_nuclei
    from saguaro_tpu_torch.pipeline.segment_embed import SegmentEmbedConfig, SegmentEmbedEngine

    rng = np.random.default_rng(seed)
    write_training_pairs(os.path.join(root, "train"), n_train, size, TRAIN_NUCLEI, rng)
    held = write_training_pairs(os.path.join(root, "held"), n_held, size, TRAIN_NUCLEI, rng)
    ckpt = os.path.join(root, "cpnet.ckpt")
    on_card = torch.device(dev).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    result, timer = train_segmenter([
        "--data_dir", os.path.join(root, "train"), "--output", ckpt, "--steps", str(steps),
        "--batch_size", str(batch), "--tile", str(size), "--device", str(dev)])
    peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
    warm = result.step_seconds[10:] or result.step_seconds
    s_step = float(np.median(warm))
    flops = 3 * batch * cpnet_conv_flops(CellposeConfig(tile=size), size)

    cfg = SegmentEmbedConfig(channels=["DNA"], cellpose_checkpoint=ckpt,
                             diameter=CellposeConfig().diam_mean, **({"effnet": effnet} if effnet else {}))
    engine = SegmentEmbedEngine(cfg, device=dev)
    imgs = [tiff.imread(os.path.join(root, "held", f"img{i}.tiff")) for i in range(n_held)]
    held_labels, held_s = segment_trained(engine, imgs)
    img, field_gt = synthetic_nuclei(rng, size=field, n_cells=field_nuclei)
    field_labels, field_s = segment_trained(engine, [(img[..., 0] * 1000).astype(np.uint16)])
    return {
        "steps": len(result.losses), "first_loss": result.losses[0], "last_loss": result.losses[-1],
        "s_per_step": s_step, "images_per_s": batch / s_step,
        "bf16_peak_share": flops / s_step / BF16_OPS_PER_S, "step_tflop": flops / 1e12,
        "peak_gb": peak, "flows_s": timer.total["flows"], "train_s": timer.total["train"],
        "held_iou": float(np.mean([iou_matched(g, p) for g, p in zip(held, held_labels)])),
        "held_objects": [int(p.max()) for p in held_labels], "held_placed": [int(g.max()) for g in held],
        "held_s_per_site": held_s, "field_iou": iou_matched(field_gt, field_labels[0]),
        "field_objects": int(field_labels[0].max()), "field_placed": int(field_gt.max()),
        "field_s_per_site": field_s,
    }


def check_training(got: dict) -> None:
    """The reference's criteria (tests/test_train.py:70, :82): the last loss
    below half the first, a mean matched IoU above ``TRAIN_IOU`` on the
    held-out tiles and on the field."""
    if not got["last_loss"] < 0.5 * got["first_loss"]:
        raise AssertionError(f"training did not halve its loss: {got['first_loss']:.4f} -> "
                             f"{got['last_loss']:.4f}")
    for part in ("held", "field"):
        if not got[f"{part}_iou"] > TRAIN_IOU:
            raise AssertionError(f"the trained net's {part} IoU {got[part + '_iou']:.3f} <= {TRAIN_IOU}")


def hold_training_against_cpu(dev, steps: int = 5, size: int = 64) -> float:
    """A small CPnet (features 8-64, tile ``size``, f32, TF32 off) trained
    ``steps`` steps on the card and on the CPU from the same seeded weights
    and batches: the largest relative difference of the losses, which must
    stay within ``TRAIN_CPU_RTOL``."""
    from saguaro_tpu_torch.device import full_f32
    from saguaro_tpu_torch.models.cellpose import CellposeConfig
    from saguaro_tpu_torch.models.cellpose_train import masks_to_flows, synthetic_nuclei, train_cellpose

    rng = np.random.default_rng(52)
    images, flows, probs = [], [], []
    for _ in range(8):
        img, lab = synthetic_nuclei(rng, size=size, n_cells=4)
        images.append(img)
        flows.append(masks_to_flows(lab, device="cpu"))
        probs.append((lab > 0).astype(np.float32))
    data = (np.stack(images), np.stack(flows), np.stack(probs))
    cfg = CellposeConfig(tile=size, features=(8, 16, 32, 64), compute_dtype="float32")
    with full_f32():
        card = train_cellpose(*data, cfg, n_steps=steps, batch_size=4, learning_rate=1e-3, device=dev)
        cpu = train_cellpose(*data, cfg, n_steps=steps, batch_size=4, learning_rate=1e-3, device="cpu")
    worst = float(np.max(np.abs(np.subtract(card.losses, cpu.losses)) / np.abs(cpu.losses)))
    log(f"training card vs CPU ({steps} f32 steps, features 8-64, {size}²): losses {card.losses} vs "
        f"{cpu.losses}, worst relative difference {worst:.3g} (tolerance {TRAIN_CPU_RTOL})")
    if worst > TRAIN_CPU_RTOL:
        raise AssertionError(f"card and CPU training differ by {worst:.3g} relative")
    return worst


def profile_stages(images, gt_labels, dev, top: int = 20) -> None:
    """``--profile``: each stage of the main path once more, warmed up, first
    timed alone (host clock to a synchronise) and then under torch.profiler;
    logs wall seconds, device-busy seconds (the sum of kernel times, one
    stream), kernel launches, and the ops whose own kernels took the most
    device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from saguaro_tpu_torch.kernels.flow_ode import centroid_flows, compute_masks_batch
    from saguaro_tpu_torch.pipeline.features import measure_site_batch
    from saguaro_tpu_torch.pipeline.segment_embed import SegmentEmbedConfig, SegmentEmbedEngine

    engine = SegmentEmbedEngine(SegmentEmbedConfig(channels=list(CHANNELS), diameter=100.0),
                                seed=0, device=dev)
    flows = np.stack([centroid_flows(g) for g in gt_labels]) * 5.0
    prob = np.where(gt_labels > 0, 5.0, -5.0).astype(np.float32)
    stages = {
        "segment": lambda: engine.segment_batch(images),
        "recover": lambda: compute_masks_batch(flows, prob, device=dev),
        "embed": lambda: engine.embed_sites_pooled(images, list(gt_labels)),
        "measure": lambda: measure_site_batch(images, gt_labels, feature_config(), device=dev),
    }
    for name, fn in stages.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        alone = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            traced = time.perf_counter() - t0
        events = prof.key_averages()
        # the measure/<family> ranges appear twice: as host events and as
        # device-timeline annotations, which are not kernels
        spans = [e for e in events if e.key.startswith("measure/")]
        kernels = [e for e in events
                   if e.device_type == DeviceType.CUDA and not e.key.startswith("measure/")]
        busy = sum(e.self_device_time_total for e in kernels) / 1e6
        n_launch = sum(e.count for e in kernels)
        log(f"profile {name}: {alone:.4f} s alone, {traced:.4f} s traced for {len(images)} sites; "
            f"device busy {busy:.4f} s ({100 * busy / traced:.1f} % of traced), "
            f"{n_launch} kernel launches")
        ops = [e for e in events if e.device_type == DeviceType.CPU]
        # the port's own kernels (csrc/*.cu) in this stage
        for e in sorted((e for e in kernels if "sag_" in e.key),
                        key=lambda e: e.device_time_total, reverse=True):
            log(f"  kernel {e.device_time_total / 1e3:10.3f} ms dev  {e.count:6d} launches  {e.key[:80]}")
        for e in sorted(ops, key=lambda e: e.self_device_time_total, reverse=True)[:top]:
            log(f"  {e.self_device_time_total / 1e3:10.3f} ms dev  {e.count:6d} calls  "
                f"{e.self_cpu_time_total / 1e3:10.3f} ms cpu  {e.key[:90]}")
        # the measure stage's family ranges: host time (inclusive of the
        # syncs inside), device time and count of the kernels launched
        # within, PyTorch's and the port's apart (each kernel once, through
        # the op its launch is linked to), and the range's extent on the
        # device timeline
        extent = {e.key: e.device_time_total for e in spans if e.device_type == DeviceType.CUDA}
        host = [e for e in spans if e.device_type == DeviceType.CPU]
        by_range, port_all, port_inside = trace_ranges(prof)
        if name == "measure":
            # each launch is an op of its own (segment_cuda._launch), so its
            # kernel lands in the family range that encloses it
            log(f"  the port's kernels: {port_all} launched, {port_inside} of them inside a "
                "measure/<family> range")
        for e in sorted(host, key=lambda e: e.cpu_time_total, reverse=True):
            us_t, n_t, us_p, n_p = by_range.get(e.key, (0.0, 0, 0.0, 0))
            log(f"  range {e.key:24s} {e.count:3d} calls  {e.cpu_time_total / 1e3:10.3f} ms host  "
                f"{(us_t + us_p) / 1e3:10.3f} ms kernels ({us_t / 1e3:.3f} PyTorch's, "
                f"{us_p / 1e3:.3f} the port's in {n_p} launches)  "
                f"{extent.get(e.key, 0.0) / 1e3:10.3f} ms device extent  {n_t + n_p:7d} launches")
        if name == "measure" and port_inside != port_all:
            raise AssertionError("the profiler puts some of the port's kernels outside the "
                                 "measure/<family> ranges")


def trace_ranges(prof) -> tuple[dict, int, int]:
    """``range_kernels`` of a finished torch.profiler ``prof``'s events."""
    from torch.autograd import DeviceType

    raw = list(prof.profiler.kineto_results.events())
    on_cpu = [k for k in raw if k.device_type() == DeviceType.CPU]
    return range_kernels(
        [(k.start_thread_id(), k.start_ns(), k.end_ns(), k.name()) for k in on_cpu
         if k.name().startswith("measure/")],
        # ops: the CPU events no other event links to (runtime calls link to
        # their op, and carry a correlation id of another count)
        [(k.start_thread_id(), k.start_ns(), k.correlation_id()) for k in on_cpu
         if k.linked_correlation_id() == 0 and not k.name().startswith("measure/")],
        [(k.name(), k.linked_correlation_id(), (k.end_ns() - k.start_ns()) / 1e3)
         for k in raw if k.device_type() == DeviceType.CUDA and not k.name().startswith("measure/")])


def range_kernels(spans: list, ops: list, device: list) -> tuple[dict, int, int]:
    """Device work by ``measure/<family>`` range, from a trace's events:
    ``spans``, each range as (thread, start ns, end ns, name); ``ops``,
    each op that can launch as (thread, start ns, correlation id);
    ``device``, each device activity once as (name, the correlation id of
    the op that launched it, us). An op lies in the ranges of its thread
    that contain its start. Returns ({range: [PyTorch's us, its launches,
    the port's (``sag_*``) us, its launches]}, the port's launches, those
    inside a range); a launch counts in every range around it. Id 0 links
    nothing."""
    op_ranges: dict[int, set] = {}
    for thread, t0, corr in ops:
        if corr:
            op_ranges[corr] = {n for th, a, b, n in spans if th == thread and a <= t0 < b}
    by_range: dict[str, list] = {}
    port_all = port_inside = 0
    for kname, corr, us in device:
        port = "sag_" in kname
        ranges = op_ranges.get(corr, set())
        port_all += port
        port_inside += port and bool(ranges)
        for r in ranges:
            acc = by_range.setdefault(r, [0.0, 0, 0.0, 0])
            acc[2 * port] += us
            acc[2 * port + 1] += 1
    return by_range, port_all, port_inside


def profile_pixel_path(dev, top: int = 8) -> None:
    """``--profile``: the pixel path once more under torch.profiler; logs
    the device-busy seconds (the sum of kernel times) against the stages'
    wall seconds, host I/O included, and the kernels with the most device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        secs = run_pixel_path(dev)
    wall = sum(secs.values()) * PIX_FIELDS * len(CHANNELS)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    log(f"profile pixel path: stages {wall:.4f} s wall (traced), device busy {busy:.4f} s "
        f"({100 * busy / wall:.2f} %), {sum(e.count for e in kernels)} kernel launches; "
        "s/image " + json.dumps(secs))
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:top]:
        log(f"  {e.self_device_time_total / 1e3:10.3f} ms dev  {e.count:6d} launches  {e.key[:80]}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on the card", file=sys.stderr)
        return 2
    try:
        from saguaro_tpu_torch.kernels import segment_cuda as sc
    except ImportError as e:
        print(f"chip_smoke: the saguaro_tpu_torch package is missing ({e})", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; card: {smi}")

    t0 = time.perf_counter()
    lib = sc.build_kernels()
    sc._lib()
    log(f"built {lib.name} in {time.perf_counter() - t0:.1f} s")
    log_resources((lib.parent / "build.log").read_text())

    images, gt = synthetic_sites(N_SITES, SIZE, seed=0)
    n_cells = int(gt[0].max())
    log(f"{N_SITES} sites {SIZE}x{SIZE}x{len(CHANNELS)}, {n_cells} cells/site")
    check_lane_adversarial(dev)
    kernels, counters, add_entry = check_kernels(images, gt, dev)
    # K1-K6 run on the feature-extraction path, K7 on the pixel path; a K1
    # row's counter is ("seg_counts", its call site)
    measure_kernels = sorted({c if isinstance(c, str) else c[0] for c in counters.values()}
                             - {"lanczos_resize"})

    check_small_against_cpu(dev)

    sc.reset_launch_counts()
    with K1Sites(keep=False) as k1_sites, K3Sites(keep=False) as k3_sites:
        tables, rec, secs = run_main_path(images, gt, dev)
        torch.cuda.synchronize()
    launches = dict(sc.LAUNCHES)
    sites = {"seg_counts": k1_sites, "seg_sums": k3_sites}
    log(f"main path launches {launches}; s/site " + ", ".join(f"{k} {v:.4f}" for k, v in secs.items()))
    log("main path K1 launches by call site and shape (max_cells x planes): " + "; ".join(
        f"{k1_sites.names()[k]} {k[:3]} {k[3]} x {len(k[4])} planes {sorted(set(k[4]))}: {c}"
        for k, c in k1_sites.calls.items()))
    log(f"main path K3 launches by call site: {k3_sites.calls}")
    for counter, rec_sites in sites.items():
        if sum(rec_sites.calls.values()) != launches[counter]:
            raise AssertionError(f"{counter}'s call sites {rec_sites.calls} do not add up to its "
                                 f"{launches[counter]} launches")
    check_recovery(rec, gt)
    check_tables(tables, n_cells)
    missing = [k for k in measure_kernels if launches[k] < 1]
    missing += [n for n, c in counters.items()
                if isinstance(c, tuple) and c[1] not in sites[c[0]].calls]
    if missing:
        raise AssertionError(f"the main path did not launch {missing}")
    for name, entry in kernels.items():
        c = counters[name]
        entry["launches"] = launches[c] if isinstance(c, str) else sites[c[0]].calls[c[1]]

    log("stage seconds per site " + json.dumps(secs))

    # the later phases, each its own path with the counts set to 0 before it
    t0 = time.perf_counter()
    fine, k3_fine = run_fine_costes(images, rec, dev, n_cells)
    hold_k3_site(k3_fine, K3_FINE_SITE, "seg_sums[costes_fine]", dev, add_entry, count_lane=0)
    kernels["seg_sums[costes_fine]"]["launches"] = fine["k3_launches"]
    del k3_fine
    fine.update(check_fine_costes_against_cpu(images, rec, dev))
    log(f"fine Costes phase {time.perf_counter() - t0:.1f} s: " + json.dumps(fine))
    t0 = time.perf_counter()
    oracles = check_oracles(images, gt, dev)
    log(f"oracles phase {time.perf_counter() - t0:.1f} s: " + json.dumps(oracles))
    t0 = time.perf_counter()
    family, family_runs = run_family_api(images, gt, dev)
    family["rows"] = hold_family_kernels(family_runs, dev, add_entry)
    for name, n in family["rows"].items():
        kernels[name]["launches"] = n
    del family_runs
    log(f"family-API phase {time.perf_counter() - t0:.1f} s: " + json.dumps(family))
    t0 = time.perf_counter()
    gran = check_granularity(images, dev)
    log(f"granularity phase {time.perf_counter() - t0:.1f} s: " + json.dumps(gran))
    t0 = time.perf_counter()
    mesh = run_mesh_phase(images, gt, rec, tables, dev, measure_kernels)
    log(f"mesh phase {time.perf_counter() - t0:.1f} s: " + json.dumps(mesh))

    sc.reset_launch_counts()
    single = run_single_site(images, gt, dev)
    log("single-site seconds " + json.dumps(single) + f"; launches {dict(sc.LAUNCHES)}")

    sc.reset_launch_counts()
    embed = run_embed(images, gt, dev)
    log("embed " + json.dumps(embed) + f"; launches {dict(sc.LAUNCHES)}")
    sc.reset_launch_counts()
    cli = run_cli(dev)
    log("segment-embed CLI " + json.dumps(cli) + f"; launches {dict(sc.LAUNCHES)}")

    hold_training_against_cpu(dev)
    with tempfile.TemporaryDirectory() as train_root:
        sc.reset_launch_counts()
        training = run_training(dev, train_root)
        log("training " + json.dumps(training) + f"; launches {dict(sc.LAUNCHES)}")
    check_training(training)

    with tempfile.TemporaryDirectory() as grid_root:
        sc.reset_launch_counts()
        grid = run_grid(grid_root, dev, profile="--profile" in sys.argv[1:])
        torch.cuda.synchronize()
        grid_launches = dict(sc.LAUNCHES)
        log("job grid " + json.dumps(grid) + f"; launches {grid_launches}")
        missing = [k for k in measure_kernels if grid_launches[k] < 1]
        if missing:
            raise AssertionError(f"the job grid did not launch {missing}")
        sc.reset_launch_counts()
        profile_secs = run_profile_phase(grid_root, dev)
        log("profile phase " + json.dumps(profile_secs) + f"; launches {dict(sc.LAUNCHES)}")
    log("TIFF phase " + json.dumps(run_tiff_phase(dev)))

    check_pixel_small_against_cpu(dev)
    sc.reset_launch_counts()
    pix_secs = run_pixel_path(dev)
    torch.cuda.synchronize()
    pix_launches = dict(sc.LAUNCHES)
    log(f"pixel path launches {pix_launches}; s/image " + json.dumps(pix_secs))
    if pix_launches["lanczos_resize"] < 1:
        raise AssertionError("the pixel path did not launch K7 (lanczos_resize)")
    kernels["lanczos_resize"]["launches"] = pix_launches["lanczos_resize"]

    if "--profile" in sys.argv[1:]:
        profile_stages(images, gt, dev)
        profile_pixel_path(dev)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
