"""Times K1 (``csrc/counts.cu``) at every shape the measurement's main path
gives it, in variants, on one NVIDIA GPU: chip_smoke's inputs (8 sites of
1080 x 1080 x 5 channels, max_cells 512, the default FeatureConfig), each
call site's first inputs kept from one ``measure_site_batch``.

    python3 tools/k1_variants.py [--parent CHECKOUT] [variant ...]

Variants: ``parent`` builds the counts.cu of another checkout (the kernel
before the redesign: int32 codes, a table over 200 KB counted in global
memory; CHECKOUT from ``git archive`` of that commit); the others use this
checkout's source, text-patched (PATCHES) or under other plans: the
plan's module constants in ``segment_cuda`` replaced (PLANS).
Each source is built alone with the package's nvcc flags under
saguaro_tpu_torch/_build/k1_variants/ (all builds started together). Each
variant is timed at every site (median of 20 CUDA-event timings after 2
warm-ups, as chip_smoke.time_ms) in the order given, the first again last.
Prints the card's name and power limit, then one JSON line a variant."""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from saguaro_tpu_torch.kernels import segment_cuda as sc  # noqa: E402
from saguaro_tpu_torch.pipeline.features import measure_site_batch  # noqa: E402

CSRC = ROOT / "saguaro_tpu_torch" / "csrc"
BUILD = ROOT / "saguaro_tpu_torch" / "_build" / "k1_variants"
PATCHES = {
    "base": [],
    # no merge of a thread's equal consecutive keys: one atomic a pixel and plane
    "noruns": [("#define SAG_COUNTS_RUNS 1 ", "#define SAG_COUNTS_RUNS 0 ")],
    # 256 threads a CTA (the plan's constants follow)
    "threads256": [("#define SAG_COUNTS_THREADS 512 ", "#define SAG_COUNTS_THREADS 256 ")],
    # 1 or 4 octets' labels in flight a thread
    "unroll1": [("#define SAG_COUNTS_UNROLL 2 ", "#define SAG_COUNTS_UNROLL 1 ")],
    "unroll4": [("#define SAG_COUNTS_UNROLL 2 ", "#define SAG_COUNTS_UNROLL 4 ")],
    # 1 or 4 code planes of an octet in flight
    "ahead1": [("#define SAG_COUNTS_AHEAD 8 ", "#define SAG_COUNTS_AHEAD 1 ")],
    "ahead4": [("#define SAG_COUNTS_AHEAD 8 ", "#define SAG_COUNTS_AHEAD 4 ")],
}
# plan variants of the base source: the module constants of segment_cuda
# they replace
PLANS = {
    # row tiles wherever a table exceeds a slice, or a cluster wherever it does
    "tiles": {"K1_CLUSTER_RATIO": 1 << 30},
    "cluster": {"K1_CLUSTER_RATIO": 0},
    "nocopies": {"K1_COPIES_BYTES": 0},
    "slice100": {"K1_SLICE": 100 * 1024},
    "threads256": {"K1_THREADS": 256, "K1_MIN_PIXELS": 256 * 8 * 4},
    "waves1": {"K1_WAVES": 1},
    "waves16": {"K1_WAVES": 16},
    "cluster_waves1": {"K1_CLUSTER_RATIO": 0, "K1_WAVES": 1},
    "cluster_waves16": {"K1_CLUSTER_RATIO": 0, "K1_WAVES": 16},
}


def _nvcc(out: Path, sources: list[Path]) -> subprocess.Popen:
    cmd = [sc._nvcc(), *sc._NVCC_FLAGS, "-shared", "-o", str(out / "lib.so"), *map(str, sources)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def build(names: list[str], parent: Path | None) -> dict[str, ctypes.CDLL]:
    """One library per source (the plan variants share the base's)."""
    sources = {n: n for n in names if n in PATCHES}
    if any(n in PLANS and n not in PATCHES for n in names):
        sources["base"] = "base"
    if "parent" in names:
        sources["parent"] = "parent"
    procs = {}
    for name in sources:
        out = BUILD / name
        out.mkdir(parents=True, exist_ok=True)
        src_dir = (parent / "saguaro_tpu_torch" / "csrc") if name == "parent" else CSRC
        text = (src_dir / "counts.cu").read_text()
        for old, new in PATCHES.get(name, []):
            if text.count(old) != 1:
                raise ValueError(f"variant {name}: patch target not found once: {old!r}")
            text = text.replace(old, new)
        (out / "counts.cu").write_text(text)
        for f in ("common.cuh", "errors.cu"):
            (out / f).write_text((src_dir / f).read_text())
        procs[name] = (_nvcc(out, [out / "counts.cu", out / "errors.cu"]), time.perf_counter())
    libs = {}
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, (proc, t0) in procs.items():
        log = proc.communicate()[0]
        (BUILD / name / "build.log").write_text(log)
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} does not build:\n{log[-3000:]}")
        lib = ctypes.CDLL(str(BUILD / name / "lib.so"))
        if name == "parent":
            lib.sag_counts.argtypes = [p, p, p, p, i, ll, i, i, i, p]
        else:
            for fn in ("sag_counts", "sag_counts_info"):
                getattr(lib, fn).argtypes = list(sc.SIGNATURES[fn])
                getattr(lib, fn).restype = ctypes.c_int
        lib.sag_counts.restype = ctypes.c_int
        lib.sag_error_string.argtypes = [ctypes.c_int]
        lib.sag_error_string.restype = ctypes.c_char_p
        libs[name] = lib
        rep = [r for r in cs.ptxas_report(log) if "counts" in r["name"]]
        print(json.dumps({"variant": name, "build_s": round(time.perf_counter() - t0, 1),
                          "registers": [r["registers"] for r in rep],
                          "spill_bytes": sum(r["spill_stores"] + r["spill_loads"] for r in rep)}),
              flush=True)
    return libs


def parent_call(lib, lab, codes32, sizes, mc):
    """The parent kernel's binding: int32 codes, the plan of offsets and
    sizes on the device, one launch."""
    offs, total = sc._plan(sizes)
    plan = torch.tensor(offs + list(sizes), dtype=torch.int32, device=lab.device)
    b, n = lab.shape
    out = torch.zeros((b, mc, total), dtype=torch.int32, device=lab.device)
    rc = lib.sag_counts(lab.data_ptr(), codes32.data_ptr(), plan.data_ptr(), out.data_ptr(), b, n,
                        len(sizes), mc, total, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"parent sag_counts failed: {rc}")
    return out.float()


def main() -> int:
    args = sys.argv[1:]
    parent = None
    if args[:1] == ["--parent"]:
        parent, args = Path(args[1]).resolve(), args[2:]
    names = args or ["base", *PLANS, "noruns"]
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    sc._lib()
    libs = build(names, parent)
    images, labels = cs.synthetic_sites(cs.N_SITES, cs.SIZE, seed=0)
    with cs.K1Sites(keep=True) as rec:
        measure_site_batch(images, labels, cs.feature_config(), device=dev)
    site_names = rec.names()
    for name in names + names[:1]:
        row = {"variant": name}
        consts = PLANS.get(name, {})
        saved = {k: getattr(sc, k) for k in consts}
        for k, v in consts.items():
            setattr(sc, k, v)
        try:
            for key, (lab, codes) in rec.inputs.items():
                _, _, _, mc, sizes = key
                want = sc.counts_plain(lab, codes, sizes, mc)
                if name == "parent":
                    c32 = codes.to(torch.int32)

                    def fn(lab=lab, c32=c32, sizes=sizes, mc=mc):
                        return parent_call(libs["parent"], lab, c32, sizes, mc)
                else:
                    sc._LIB = libs[name if name in libs else "base"]

                    def fn(lab=lab, codes=codes, sizes=sizes, mc=mc):
                        return sc.seg_counts(lab, codes, sizes, mc)
                if not torch.equal(fn(), want):
                    raise AssertionError(f"variant {name} differs at {site_names[key]}")
                row[site_names[key]] = round(cs.time_ms(fn, 20), 4)
        finally:
            for k, v in saved.items():
                setattr(sc, k, v)
        row["sum_ms_by_launches"] = round(sum(row[site_names[k]] * c for k, c in rec.calls.items()), 3)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
