"""Times text-patched variants of ``csrc/lane_sums.cu`` (the K4 pass A, C
and E run kernels) at chip_smoke's inputs on one NVIDIA GPU, to see what
limits them: 8 sites of 1080 x 1080 x 5 channels, max_cells 512, pass A
with edge lanes, pass C with every family on (and each (moments, zernike,
edge) combination), pass E on the nuclei with thresholds at 15 % of each
label's channel maximum.

    python3 tools/k4_variants.py [variant ...]

Each variant is the source with the patches of VARIANTS applied, built
alone with the package's nvcc flags under saguaro_tpu_torch/_build/
variants/ (all builds started together), then timed through the package's
wrappers (median of 20 CUDA-event timings after 2 warm-ups, as
chip_smoke.time_ms) in the order given, the first variant again last.
Prints one JSON line per timing and the card's name and power limit."""

from __future__ import annotations

import ctypes
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from saguaro_tpu_torch.kernels import segment_cuda as sc  # noqa: E402
from saguaro_tpu_torch.kernels.segment_reduce import perimeter_weight_image  # noqa: E402
from saguaro_tpu_torch.kernels.zernike import _radial_coeffs  # noqa: E402

CSRC = ROOT / "saguaro_tpu_torch" / "csrc"
BUILD = ROOT / "saguaro_tpu_torch" / "_build" / "variants"
RED = "  atomicAdd(p, v);\n  v = 0.0f;"
E_BOUNDS = "__launch_bounds__(SAG_RUN_THREADS, SAG_RUN_MIN_BLOCKS)\nsag_lanes_e_kernel"
VARIANTS = {
    "base": [],
    # the flush's atomics replaced by plain stores (wrong sums, timing only)
    "stores": [(RED, "  *p = v;\n  v = 0.0f;")],
    # no flush at all: the lanes are built, never written (timing only)
    "noflush": [(RED, "  if (v == -7.0f) *p = v;\n  v = 0.0f;")],
    # staging and walk only: no lane is built (timing only)
    "nopixel": [("        body.pixel(v0 + k * n_ch, v1 + k * n_ch, i);\n", "")],
    "stages3": [("#define SAG_STAGES 2 ", "#define SAG_STAGES 3 ")],
    "step8": [("#define SAG_STEP_PX 4 ", "#define SAG_STEP_PX 8 "),
              ("#define SAG_STEPS 16 ", "#define SAG_STEPS 8 ")],
    "e_pairs5": [("#define SAG_E_PAIRS 10 ", "#define SAG_E_PAIRS 5 ")],
    "e_blocks4": [(E_BOUNDS, E_BOUNDS.replace("SAG_RUN_MIN_BLOCKS", "4"))],
    # pass A without its perimeter-weight read in the walk (timing only)
    "a_nopw": [("    acc[4] += __ldg(pweight + i);\n", "")],
}


def build(names: list[str]) -> dict[str, ctypes.CDLL]:
    src = (CSRC / "lane_sums.cu").read_text()
    procs = {}
    for name in names:
        out = BUILD / name
        out.mkdir(parents=True, exist_ok=True)
        text = src
        for old, new in VARIANTS[name]:
            if text.count(old) != 1:
                raise ValueError(f"variant {name}: patch target not found once: {old!r}")
            text = text.replace(old, new)
        (out / "lane_sums.cu").write_text(text)
        for f in ("common.cuh", "errors.cu"):
            (out / f).write_text((CSRC / f).read_text())
        cmd = [sc._nvcc(), *sc._NVCC_FLAGS, "-shared", "-o", str(out / "lib.so"),
               str(out / "lane_sums.cu"), str(out / "errors.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), time.perf_counter())
    libs = {}
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, (proc, t0) in procs.items():
        log = proc.communicate()[0]
        (BUILD / name / "build.log").write_text(log)
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} does not build:\n{log[-3000:]}")
        lib = ctypes.CDLL(str(BUILD / name / "lib.so"))
        lib.sag_lanes_a.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, p]
        lib.sag_lanes_c.argtypes = [p, p, p, p, i, p, p, i, i, i, i, i, i, i, i, i, p]
        lib.sag_lanes_e.argtypes = [p, p, p, p, p, p, i, ll, i, i, i, p]
        lib.sag_lanes_a.restype = lib.sag_lanes_c.restype = lib.sag_lanes_e.restype = ctypes.c_int
        lib.sag_error_string.argtypes = [ctypes.c_int]
        lib.sag_error_string.restype = ctypes.c_char_p
        libs[name] = lib
        regs = [r["registers"] for r in cs.ptxas_report(log) if "lanes_" in r["name"]]
        spills = sum(r["spill_stores"] + r["spill_loads"] for r in cs.ptxas_report(log))
        print(json.dumps({"variant": name, "build_s": round(time.perf_counter() - t0, 1),
                          "registers": regs, "spill_bytes": spills}), flush=True)
    return libs


def inputs(dev):
    images, labels = cs.synthetic_sites(cs.N_SITES, cs.SIZE, seed=0)
    b, h, w, n_ch = images.shape
    img = torch.as_tensor(images.astype(np.float32), device=dev)
    lab = torch.as_tensor(labels, device=dev)
    pw, border = perimeter_weight_image(lab)
    bnd = border.to(torch.uint8).contiguous()
    a = sc.lane_sums_a_plain(lab, img, pw.contiguous(), bnd, cs.MAX_CELLS, True)
    cnt = a[..., 0].clamp(min=1.0)
    cols = {"c": torch.stack([a[..., 1] / cnt, a[..., 2] / cnt], -1),
            "bbox": torch.stack([a[..., 1] / cnt - 20, a[..., 2] / cnt - 20], -1),
            "rmax": torch.full_like(cnt, 21.0)[..., None],
            "mean": a[..., 5:5 + n_ch] / cnt[..., None],
            "emean": a[..., 5 + 3 * n_ch:5 + 4 * n_ch] / a[..., 3:4].clamp(min=1.0)}
    zc = torch.tensor(_radial_coeffs(), dtype=torch.float32, device=dev)

    def args_c(m, z, e):
        keys = ["c"] + (["bbox"] if m else []) + (["rmax"] if z else []) + ["mean"] \
            + (["emean"] if e else [])
        table = torch.cat([cols[k] for k in keys], -1).contiguous()
        return lab, img, bnd, table, zc, cs.MAX_CELLS, m, z, e

    n = h * w
    flat = lab.reshape(b, n).contiguous()
    vr = img.reshape(b, n, n_ch).contiguous()
    seg = torch.where((flat > 0) & (flat < cs.MAX_CELLS), flat, 0).long()
    vmax = torch.zeros((b, cs.MAX_CELLS, n_ch), device=dev).scatter_reduce_(
        1, seg[..., None].expand(b, n, n_ch), vr, "amax")
    g = torch.Generator(device=dev).manual_seed(3)
    ranks = torch.randint(0, 3000, (b, n, n_ch), generator=g, device=dev).float()
    pairs = [(p, q) for p in range(n_ch) for q in range(p + 1, n_ch)]
    mean = vr[flat > 0].mean(0)
    thr = torch.stack([torch.stack([mean[p] for p, _ in pairs]), torch.stack([mean[q] for _, q in pairs]),
                       torch.full((len(pairs),), 1 / 3000.0, device=dev)])
    args_e = (flat, vr, ranks, (0.15 * vmax).contiguous(), thr[None].expand(b, 3, len(pairs)).contiguous(),
              cs.MAX_CELLS)
    return (lab, img, pw.contiguous(), bnd, cs.MAX_CELLS, True), args_c, args_e


def main() -> int:
    names = sys.argv[1:] or list(VARIANTS)
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    libs = build(names)
    args_a, args_c, args_e = inputs(dev)
    full = args_c(True, True, True)
    for name in names + names[:1]:
        sc._LIB = libs[name]
        rec = {"variant": name, "A_ms": cs.time_ms(lambda: sc.seg_lane_sums_a(*args_a), 20),
               "C_ms": cs.time_ms(lambda: sc.seg_lane_sums_c(*full), 20),
               "E_ms": cs.time_ms(lambda: sc.seg_lane_sums_e(*args_e), 20)}
        for flags in itertools.product([False, True], repeat=3):
            a = args_c(*flags)
            rec["C_ms_mze_" + "".join(str(int(f)) for f in flags)] = round(
                cs.time_ms(lambda: sc.seg_lane_sums_c(*a), 10), 4)
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
