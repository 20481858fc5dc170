"""Times K3 (``csrc/sums.cu``) and K7 (``csrc/lanczos.cu``) at the main
path's shapes on one NVIDIA GPU, a parent checkout's kernels beside this
one's.

K3 at its two call sites on the feature-extraction path, with the inputs
one ``measure_site_batch`` gives it at chip_smoke's point (8 sites of 1080
x 1080 x 5 channels, max_cells 512, the default FeatureConfig): the Euler
corner streams and the radius sums. K7 at chip_smoke's four shapes.

    python3 tools/k3_k7_variants.py [--parent CHECKOUT] [variant ...]

Variants: ``base``, this checkout's kernels through the package's plans;
the names of PATCHES, this checkout's sources text-patched (most compute
wrong sums and are timed only), built alone and called as ``base``;
``parent``, the ``sums.cu`` and ``lanczos.cu`` of CHECKOUT (unpack the
commit with ``git archive`` into a git-ignored directory) built alone with
the package's nvcc flags under saguaro_tpu_torch/_build/k3_k7_variants/
and called through their own C interface: one K3 launch into a
zero-filled output, one K7 launch with ``resample.axis_windows`` tables.
Each variant is held against the plain forms (K3's Euler sums exactly,
its radius sums and K7's sums to chip_smoke.SUM_RTOL of their magnitude)
and timed bare (the C call alone, back to back, with every table and
output made beforehand: ``chip_smoke.time_launches_ms``), in the order
given, the first again last. This checkout's wrappers
(``segment_cuda.seg_sums``, ``resample.lanczos_resample``) are timed once
as chip_smoke times them (``chip_smoke.time_ms``). Prints the card's name
and power limit, the variants' registers and spills, then one JSON line
a timing row."""

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
from saguaro_tpu_torch.kernels import resample as rs  # noqa: E402
from saguaro_tpu_torch.kernels import segment_cuda as sc  # noqa: E402
from saguaro_tpu_torch.pipeline.features import measure_site_batch  # noqa: E402

BUILD = ROOT / "saguaro_tpu_torch" / "_build" / "k3_k7_variants"
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the parent's C interfaces (the kernels before the redesign)
PARENT_SIGNATURES = {
    "sag_sums": (_P, _P, _P, _I, _LL, _I, _I, _P),
    "sag_lanczos": (_P, _I, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P),
}
_V_SPAN = "const int lo = max(m.x, cur.cy0), hi = min(m.x + m.y, cy1);"
_H_SPAN = "const int lo = max(m.x, cur.cx0), hi = min(m.x + m.y, cx1);"
# text patches of this checkout's sources: (file, [(old, new), ...])
PATCHES = {
    # K7 without its vertical pass, its horizontal pass or its staging (timing only)
    "lz_novert": ("lanczos.cu", [(_V_SPAN, "const int lo = 0, hi = 0;")]),
    "lz_nohorz": ("lanczos.cu", [(_H_SPAN, "const int lo = 0, hi = 0;")]),
    "lz_nostage": ("lanczos.cu", [("  if (a.tma) {\n    if (threadIdx.x == 0) {",
                                   "  if (a.tma) {\n    if (false) {"),
                                  ("    if (a.tma) lz_wait(bars + (k & 1), (k >> 1) & 1);\n", "")]),
    # the vertical and the horizontal pass unrolled 2 deep (4 in the source)
    "lz_unroll2": ("lanczos.cu", [("#pragma unroll 4\n        for (int y = lo;",
                                   "#pragma unroll 2\n        for (int y = lo;"),
                                  ("#pragma unroll 4\n        for (int x = lo;",
                                   "#pragma unroll 2\n        for (int x = lo;")]),
    # integers read as their bit patterns, without the subtraction (timing only)
    "lz_noconv": ("lanczos.cu", [("  return __uint_as_float(bits) - 8388608.0f;",
                                  "  return __uint_as_float(bits);")]),
    # K3 without the warp merge: every run one shared atomic
    "k3_nomerge": ("sums.cu", [("  if (__ballot_sync(SAG_FULL_MASK, rl >= 0) == 0u) return;",
                                "  if (rl >= 0) k3_add<KC>(tab, rl, rs);\n  return;")]),
    # 4 or 8 label vectors in flight a thread (2 in the source)
    "k3_unroll4": ("sums.cu", [("#define K3_UNROLL 2 ", "#define K3_UNROLL 4 ")]),
    "k3_unroll8": ("sums.cu", [("#define K3_UNROLL 2 ", "#define K3_UNROLL 8 ")]),
}
K7_SHAPES = {
    "16x2160^2 u16->1080^2": ((cs.PIX_BATCH, cs.RAW, cs.RAW), torch.uint16, (1080, 1080)),
    "4x2160^2 f32->1080^2": ((4, cs.RAW, cs.RAW), torch.float32, (1080, 1080)),
    "2x540x720 u8->1080x1440": ((2, 540, 720), torch.uint8, (1080, 1440)),
    "1x1001x1537 u16->433x761": ((1, 1001, 1537), torch.uint16, (433, 761)),
}
_CODES = {torch.uint8: 0, torch.uint16: 1, torch.float32: 2}


def build(variants: dict[str, tuple[Path, dict]]) -> dict[str, ctypes.CDLL]:
    """For each variant name: sums.cu, lanczos.cu and errors.cu of its
    source directory (PATCHES[name] applied) built alone, all builds
    started together, into a library bound with its signatures."""
    flags = [*sc._NVCC_FLAGS, *(["-shared"] if "-shared" not in sc._NVCC_FLAGS else [])]
    procs = {}
    for name, (src, _) in variants.items():
        out = BUILD / name
        out.mkdir(parents=True, exist_ok=True)
        patched, edits = PATCHES.get(name, (None, []))
        for f in ("common.cuh", "sums.cu", "lanczos.cu", "errors.cu"):
            text = (src / f).read_text()
            for old, new in edits if f == patched else []:
                if text.count(old) != 1:
                    raise ValueError(f"variant {name}: patch target not found once: {old!r}")
                text = text.replace(old, new)
            (out / f).write_text(text)
        cmd = [sc._nvcc(), *flags, "-o", str(out / "lib.so"),
               *(str(out / f) for f in ("sums.cu", "lanczos.cu", "errors.cu"))]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), time.perf_counter())
    libs = {}
    for name, (proc, t0) in procs.items():
        log = proc.communicate()[0]
        (BUILD / name / "build.log").write_text(log)
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} does not build:\n{log[-3000:]}")
        lib = ctypes.CDLL(str(BUILD / name / "lib.so"))
        for fn, args in variants[name][1].items():
            getattr(lib, fn).argtypes = list(args)
            getattr(lib, fn).restype = ctypes.c_int
        lib.sag_error_string.argtypes = [ctypes.c_int]
        lib.sag_error_string.restype = ctypes.c_char_p
        report(name, log, time.perf_counter() - t0)
        libs[name] = lib
    return libs


def report(name: str, log: str, secs: float) -> None:
    rep = [r for r in cs.ptxas_report(log) if "sag_sums" in r["name"] or "sag_lanczos" in r["name"]]
    kernels = {n: {"registers": r["registers"], "spill": r["spill_stores"] + r["spill_loads"],
                   "smem": r["smem"]} for n, r in zip(cs.demangle([r["name"] for r in rep]), rep)}
    print(json.dumps({"variant": name, "build_s": round(secs, 1), "kernels": kernels}), flush=True)


def parent_calls(lib, k3_inputs, k7_inputs):
    """The parent's bare launches: {row name: (call, result)}."""
    dev = torch.device("cuda", 0)
    calls = {}
    for site, (lab, val, mc) in k3_inputs.items():
        b, n, k = val.shape
        out = torch.zeros((b, mc, k), dtype=torch.float32, device=dev)

        def k3(lab=lab, val=val, out=out, b=b, n=n, k=k, mc=mc):
            rc = lib.sag_sums(lab.data_ptr(), val.data_ptr(), out.data_ptr(), b, n, k, mc,
                              torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"parent sag_sums failed: {rc}")
        calls[site] = (k3, out)
    for name, (imgs, (h, w)) in k7_inputs.items():
        b, in_h, in_w = imgs.shape
        y0, ny, wy = (torch.as_tensor(a, device=dev) for a in rs.axis_windows(in_h, h))
        x0, nx, wx = rs.axis_windows(in_w, w)
        x0, nx, wxt = (torch.as_tensor(a, device=dev) for a in (x0, nx, wx.T.copy()))
        out = torch.empty((b, h, w), dtype=torch.float32, device=dev)

        def k7(imgs=imgs, out=out, t=(y0, ny, wy, x0, nx, wxt), shape=(b, in_h, in_w, h, w)):
            y0, ny, wy, x0, nx, wxt = t
            rc = lib.sag_lanczos(imgs.data_ptr(), _CODES[imgs.dtype], out.data_ptr(),
                                 y0.data_ptr(), ny.data_ptr(), wy.data_ptr(), wy.shape[1],
                                 x0.data_ptr(), nx.data_ptr(), wxt.data_ptr(), *shape,
                                 torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"parent sag_lanczos failed: {rc}")
        calls[name] = (k7, out)
    return calls


def base_calls(lib, k3_inputs, k7_inputs):
    """This checkout's bare launches through ``lib`` (the package's
    library, or a variant's): {row name: (call, None)}; the K3 calls pile
    their sums into one output and are held through the wrapper instead."""
    saved, sc._LIB = sc._LIB, lib
    try:
        calls = {site: (cs.sums_bare(lab, val, mc), None)
                 for site, (lab, val, mc) in k3_inputs.items()}
        for name, (imgs, shape) in k7_inputs.items():
            calls[name] = (cs.lanczos_bare(imgs, shape), None)
    finally:
        sc._LIB = saved
    return calls


def _sums_f64(lab, val, mc):
    """K3's plain form summed in f64."""
    b, n, k = val.shape
    ok = (lab >= 0) & (lab < mc)
    idx = torch.where(ok, lab.long() + torch.arange(b, device=lab.device)[:, None] * mc, b * mc)
    out = torch.zeros((b * mc + 1, k), dtype=torch.float64, device=lab.device)
    out.index_add_(0, idx.reshape(-1), val.reshape(b * n, k).double())
    return out[: b * mc].view(b, mc, k)


def hold(name, got, k3_inputs, k7_inputs):
    if name in k3_inputs:
        lab, val, mc = k3_inputs[name]
        want = _sums_f64(lab, val, mc)
        if name == "euler_numbers":
            if not torch.equal(got.double(), want):
                raise AssertionError("K3 Euler sums differ from the plain form")
        else:
            cs.hold_sums(f"K3 {name}", got, want, _sums_f64(lab, val.abs(), mc))
        return
    imgs, shape = k7_inputs[name]
    want = rs.resize_plain(imgs, shape, dtype=torch.float64)
    scale = rs.resize_plain(imgs, shape, magnitude=True, dtype=torch.float64)
    if not bool(((got.double() - want).abs() <= cs.SUM_RTOL * scale + 1e-6).all()):
        raise AssertionError(f"K7 {name} differs from the plain form")


def main() -> int:
    args = sys.argv[1:]
    parent = None
    if args[:1] == ["--parent"]:
        parent, args = Path(args[1]).resolve(), args[2:]
    names = args or ["parent", "base"]
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    lib = sc.build_kernels()
    libs = {"base": sc._lib()}
    report("base", (lib.parent / "build.log").read_text(), time.perf_counter() - t0)
    csrc = ROOT / "saguaro_tpu_torch" / "csrc"
    own = {f: sc.SIGNATURES[f] for f in ("sag_sums", "sag_sums_info", "sag_lanczos",
                                          "sag_lanczos_info")}
    libs.update(build({n: (parent / "saguaro_tpu_torch" / "csrc", PARENT_SIGNATURES)
                       if n == "parent" else (csrc, own) for n in names if n != "base"}))

    images, labels = cs.synthetic_sites(cs.N_SITES, cs.SIZE, seed=0)
    with cs.K3Sites(keep=True) as rec:
        measure_site_batch(images, labels, cs.feature_config(), device=dev)
    k3_inputs = rec.inputs
    del images, labels
    g = torch.Generator(device=dev).manual_seed(7)
    k7_inputs = {}
    for name, (shape, dtype, out) in K7_SHAPES.items():
        high = 65536 if dtype != torch.uint8 else 256
        x = torch.randint(0, high, shape, generator=g, device=dev, dtype=torch.int32)
        k7_inputs[name] = (x.to(dtype) if dtype != torch.float32 else x.float() * 0.37 - 1.0e4, out)

    wrapped = {"variant": "wrappers (this checkout)"}
    for site, (lab, val, mc) in k3_inputs.items():
        hold(site, sc.seg_sums(lab, val, mc), k3_inputs, k7_inputs)
        wrapped[site] = round(cs.time_ms(lambda: sc.seg_sums(lab, val, mc), 20), 4)
    for name, (imgs, shape) in k7_inputs.items():
        hold(name, rs.lanczos_resample(imgs, shape), k3_inputs, k7_inputs)
        wrapped[name] = round(cs.time_ms(lambda: rs.lanczos_resample(imgs, shape), 20), 4)
    print(json.dumps(wrapped), flush=True)

    calls = {n: parent_calls(libs[n], k3_inputs, k7_inputs) if n == "parent"
             else base_calls(libs[n], k3_inputs, k7_inputs) for n in set(names)}
    for name, rows in calls.items():
        for row, (fn, out) in rows.items():
            if out is not None:
                if row in k3_inputs:
                    out.zero_()
                fn()
                hold(row, out, k3_inputs, k7_inputs)
    for name in names + names[:1]:
        row = {"variant": name}
        for r, (fn, _) in calls[name].items():
            row[r] = round(cs.time_launches_ms(fn), 4)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
