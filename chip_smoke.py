"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels (K1-K4, ``saguaro_tpu_torch/csrc``) from the
checkout, holds each one against its plain PyTorch twin at the feature-
extraction path's shapes (8 sites of 1080 x 1080, 5 channels,
max_cells=512) and times both, then drives that path end to end through
the user-facing entry points: the full-width CPnet segmentation engine on
8 synthetic uint16 sites, mask recovery on ground-truth flows (untrained
weights find no cells), ``measure_site_batch`` at the slice's
FeatureConfig, and ``run_feature_extraction_job`` on a 2-site plate. It
fails unless every kernel was launched by that path, and prints one JSON
line of per-kernel numbers, the card's name and power limit, and last
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside it, it exits non-zero and prints no result.

    python3 chip_smoke.py --profile

also runs each stage once more, warmed up, under torch.profiler and logs
its device-busy share and the ops with the most device time.
"""

from __future__ import annotations

import json
import logging
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

SIZE = 1080
N_SITES = 8
CHANNELS = ("DNA", "GFP", "ER", "Mito", "AGP")
MAX_CELLS = 512
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_OPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
SLICE_FAMILIES_OFF = dict(
    measure_texture=False, measure_quantiles=False, measure_radius=False,
    measure_convex=False, measure_neighbors=False, measure_colocalization=False,
    measure_radial=False,
)
PALLAS = "saguaro_tpu/kernels/segment_pallas.py"
# K4 tolerance: the kernel builds its lanes in f32 and sums them with f32
# atomics in a run-dependent order; against the plain form evaluated in f64
# each sum may be off by a few dozen ulps of its rounding scale (the
# per-label sum of |lane|, and for the Zernike lanes of the radial terms'
# magnitudes, see segment_cuda._lanes_c). Count lanes are exact.
SUM_RTOL = 1e-5


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


def check_kernels(images, labels, dev):
    """Each kernel against its plain form on the main path's inputs; returns
    {kernel: entry} with error, times and bound."""
    import torch

    from saguaro_tpu_torch.kernels import segment_cuda as sc
    from saguaro_tpu_torch.kernels.segment_reduce import euler_streams, perimeter_weight_image
    from saguaro_tpu_torch.kernels.zernike import _radial_coeffs

    b, h, w, n_ch = images.shape
    n = h * w
    img = torch.as_tensor(images.astype(np.float32), device=dev)
    lab = torch.as_tensor(labels, device=dev)
    out = {}

    def entry(name, source, replaces, err, fn, plain, n_bytes, n_ops, library=None, reps=10):
        t_b, by = bound(n_bytes, n_ops)
        out[name] = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": 0, "max_abs_err": float(err),
            "ms": time_ms(fn, reps), "plain_ms": time_ms(plain, 3),
            "bound_ms": t_b, "bound_by": by,
            "library_ms": None if library is None else time_ms(library, reps),
        }
        e = out[name]
        log(f"{name}: err {e['max_abs_err']:.3g} kernel {e['ms']:.3f} ms plain {e['plain_ms']:.3f} ms "
            f"bound {e['bound_ms']:.3f} ms ({by}) library {e['library_ms']}")

    # K1: the Otsu histogram of the cell-body channel mean (256 bins per site)
    body = img[..., 1:].mean(dim=-1).reshape(b, n)
    lo, hi = body.amin(dim=1, keepdim=True), body.amax(dim=1, keepdim=True)
    q = torch.clamp((body - lo) / torch.clamp(hi - lo, min=1e-12) * 256, 0, 255).to(torch.int32)
    codes = torch.zeros((b, 1, n), dtype=torch.int32, device=dev)
    got = sc.seg_counts(q, codes, (1,), 256)
    want = sc.counts_plain(q, codes, (1,), 256)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("K1 counts differ from the plain form")
    keys = (q.long() + torch.arange(b, device=dev)[:, None] * 256).reshape(-1)
    entry("seg_counts", "saguaro_tpu_torch/csrc/counts.cu", f"{PALLAS}:252", 0.0,
          lambda: sc.seg_counts(q, codes, (1,), 256), lambda: sc.counts_plain(q, codes, (1,), 256),
          n_bytes=8.0 * b * n + 4.0 * b * 256, n_ops=float(b * n),
          library=lambda: torch.bincount(keys, minlength=b * 256))

    # K2: centroid + channel-max table gather, with empty-label sentinels
    flat = lab.reshape(b, n)
    seg = torch.where((flat > 0) & (flat < MAX_CELLS), flat, torch.zeros_like(flat)).contiguous()
    rng = np.random.default_rng(1)
    table = rng.uniform(0, 3000, (b, MAX_CELLS, 2 + n_ch)).astype(np.float32)
    table[:, 300:, 2:] = -np.inf  # absent labels: the segment-max identity
    table[:, 0, 2:] = -3.4e38
    tab = torch.as_tensor(table, device=dev)
    got = sc.seg_take_t(tab, seg, MAX_CELLS)
    want = sc.take_t_plain(tab, seg, MAX_CELLS)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("K2 gather differs from the plain form")
    site_idx = torch.arange(b, device=dev)[:, None]
    k = 2 + n_ch
    entry("seg_take_t", "saguaro_tpu_torch/csrc/take.cu", f"{PALLAS}:383", 0.0,
          lambda: sc.seg_take_t(tab, seg, MAX_CELLS), lambda: sc.take_t_plain(tab, seg, MAX_CELLS),
          n_bytes=4.0 * b * (MAX_CELLS * k + n + k * n), n_ops=0.0,
          library=lambda: tab[site_idx, seg])

    # K3: the Euler-number corner streams
    e_lab, e_val = euler_streams(lab, MAX_CELLS)
    got = sc.seg_sums(e_lab, e_val, MAX_CELLS)
    want = sc.sums_plain(e_lab, e_val, MAX_CELLS)
    torch.cuda.synchronize()
    if not torch.equal(got, want):  # small integers: exact in any order
        raise AssertionError("K3 Euler sums differ from the plain form")
    m = e_lab.shape[1]
    flat_idx = (e_lab.long() + torch.arange(b, device=dev)[:, None] * MAX_CELLS).reshape(-1)
    flat_val = e_val.reshape(-1, 1)
    acc = torch.zeros((b * MAX_CELLS, 1), device=dev)
    entry("seg_sums", "saguaro_tpu_torch/csrc/sums.cu", f"{PALLAS}:460", 0.0,
          lambda: sc.seg_sums(e_lab, e_val, MAX_CELLS), lambda: sc.sums_plain(e_lab, e_val, MAX_CELLS),
          n_bytes=8.0 * b * m + 4.0 * b * MAX_CELLS, n_ops=float(b * m),
          library=lambda: acc.index_add_(0, flat_idx, flat_val))

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
          n_ops=n_active * 2 * nl_a)

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
          n_ops=ops_c)
    return out


def slice_feature_config(**kw):
    from saguaro_tpu_torch.pipeline.features import FeatureConfig

    return FeatureConfig(**{"channels": CHANNELS, "max_cells": MAX_CELLS, **SLICE_FAMILIES_OFF, **kw})


def run_main_path(images, gt_labels, device, engine_cfg=None):
    """Segment (engine), recover masks on ground-truth flows, measure.
    Returns (tables per site, recovered labels, seconds per site by stage)."""
    import torch

    from saguaro_tpu_torch.kernels.flow_ode import centroid_flows, compute_masks_batch
    from saguaro_tpu_torch.pipeline.features import measure_site_batch
    from saguaro_tpu_torch.pipeline.segment_embed import SegmentEmbedConfig, SegmentEmbedEngine

    b = len(images)
    cfg = engine_cfg or SegmentEmbedConfig(channels=list(CHANNELS), diameter=100.0)
    engine = SegmentEmbedEngine(cfg, seed=0, device=device)
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    seg = engine.segment_batch(images)
    sync()
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
    tables = measure_site_batch(images, np.stack(rec), slice_feature_config(), device=device)
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

    cfg = slice_feature_config(max_cells=64)
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


def run_job(images, labels, dev):
    """run_feature_extraction_job on a 2-site plate written as TIFFs."""
    import pandas as pd

    from saguaro_tpu_torch.io import tiff
    from saguaro_tpu_torch.pipeline.feature_extraction import run_feature_extraction_job

    errors = []

    class _Count(logging.Handler):
        def emit(self, record):
            if record.levelno >= logging.ERROR:
                errors.append(record.getMessage())

    handler = _Count()
    logging.getLogger("saguaro_tpu_torch.feature_extraction").addHandler(handler)
    try:
        with tempfile.TemporaryDirectory() as root:
            rows = []
            for s in range(2):
                row = {"Metadata_Plate": "P1", "Metadata_Well": f"A0{s + 1}", "Metadata_Site": 1}
                for c, ch in enumerate(CHANNELS):
                    name = f"A0{s + 1}_s1_{ch}.tiff"
                    tiff.imwrite(os.path.join(root, name), images[s, ..., c])
                    row[f"FileName_{ch}"] = name
                rows.append(row)
            masks = {(r["Metadata_Well"]): labels[i] for i, r in enumerate(rows)}
            order = iter(r["Metadata_Well"] for r in rows)
            written = run_feature_extraction_job(
                pd.DataFrame(rows), root, os.path.join(root, "out"), list(CHANNELS),
                lambda image: masks[next(order)], feature_cfg=slice_feature_config(), device=dev,
            )
            tables = {k: pd.read_csv(v) for k, v in written.items()}
    finally:
        logging.getLogger("saguaro_tpu_torch.feature_extraction").removeHandler(handler)
    if sorted(tables) != ["Cells", "Cytoplasm", "Image", "Nuclei"]:
        raise AssertionError(f"job wrote {sorted(tables)}")
    if errors or sorted(set(tables["Nuclei"]["ImageNumber"])) != [1, 2]:
        raise AssertionError(f"job recorded site failures: {errors}")
    log(f"job: 4 CSVs, Nuclei rows {len(tables['Nuclei'])}, no site failures")


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
        "measure": lambda: measure_site_batch(images, gt_labels, slice_feature_config(), device=dev),
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
        kernels = [e for e in events if e.device_type == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in kernels) / 1e6
        n_launch = sum(e.count for e in kernels)
        log(f"profile {name}: {alone:.4f} s alone, {traced:.4f} s traced for {len(images)} sites; "
            f"device busy {busy:.4f} s ({100 * busy / traced:.1f} % of traced), "
            f"{n_launch} kernel launches")
        ops = [e for e in events if e.device_type == DeviceType.CPU]
        for e in sorted(ops, key=lambda e: e.self_device_time_total, reverse=True)[:top]:
            log(f"  {e.self_device_time_total / 1e3:10.3f} ms dev  {e.count:6d} calls  "
                f"{e.self_cpu_time_total / 1e3:10.3f} ms cpu  {e.key[:90]}")


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
    for line in (lib.parent / "build.log").read_text().splitlines():
        if "Used" in line or "spill" in line:
            log("ptxas: " + line.strip())

    images, gt = synthetic_sites(N_SITES, SIZE, seed=0)
    n_cells = int(gt[0].max())
    log(f"{N_SITES} sites {SIZE}x{SIZE}x{len(CHANNELS)}, {n_cells} cells/site")
    kernels = check_kernels(images, gt, dev)

    check_small_against_cpu(dev)

    sc.reset_launch_counts()
    tables, rec, secs = run_main_path(images, gt, dev)
    torch.cuda.synchronize()
    launches = dict(sc.LAUNCHES)
    log(f"main path launches {launches}; s/site " + ", ".join(f"{k} {v:.4f}" for k, v in secs.items()))
    check_recovery(rec, gt)
    check_tables(tables, n_cells)
    for name, entry in kernels.items():
        key = name.replace("seg_lane_sums[A]", "seg_lane_sums_a").replace("seg_lane_sums[C]", "seg_lane_sums_c")
        entry["launches"] = launches[key]
        if entry["launches"] < 1:
            raise AssertionError(f"{name} was not launched by the main path")

    sc.reset_launch_counts()
    run_job(images, gt, dev)
    if min(sc.LAUNCHES.values()) < 1:
        raise AssertionError(f"the job did not launch every kernel: {sc.LAUNCHES}")

    log("stage seconds per site " + json.dumps(secs))
    if "--profile" in sys.argv[1:]:
        profile_stages(images, gt, dev)
    print(json.dumps({"kernels": list(kernels.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
