"""Times K5 (``csrc/edt_sweep.cu``) and K4 radial (``csrc/radial_sums.cu``)
at chip_smoke's shapes on one NVIDIA GPU, a parent checkout's kernels
beside this one's.

K5 on the EDT inputs of chip_smoke's nuclei (8 sites of 1080 x 1080, R =
64), on 8 sparse sites (``chip_smoke.sparse_sites``: 4 small objects on
an empty field) and on an odd-width batch (2 x 1001 x 1537, R = 48, the
4-byte path); K4 radial on the nuclei's CP ring/wedge codes (8 x 1,166,400
pixels, 5 channels, max_cells 512, 32 bins) and at 1 channel on an odd
pixel count.

    python3 tools/k5_k4r_variants.py [--parent CHECKOUT] [variant ...]

Variants: ``base``, this checkout's kernels through the package's plans;
``parent``, the ``edt_sweep.cu`` and ``radial_sums.cu`` of CHECKOUT
(unpack the commit with ``git archive`` into a git-ignored directory)
built alone with the package's nvcc flags under
saguaro_tpu_torch/_build/k5_k4r_variants/ and called through their own C
interface; the names of PATCHES, text patches of this checkout's sources
or (``p_*``) of the parent's, built alone and called as ``base`` or
``parent`` (most compute wrong results and are timed only). Each variant
is held against the plain forms (K5 bit for bit, NaN for NaN; K4 radial's
counts exactly, its sums to chip_smoke.SUM_RTOL of their magnitude) and
the timing-only ones report whether they still agree. Every variant is
timed bare (the C call alone, back to back, with plans and outputs made
beforehand: ``chip_smoke.time_launches_ms``), in the order given, the
first again last. With ``base`` among them, this checkout's wrappers are
timed once as chip_smoke times them (``chip_smoke.time_ms``); with
``parent``, the parent's C call with its output allocated, as its wrapper
did. Prints the card's name and power limit, the variants' registers and
spills, then one JSON line a timing row."""

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
from saguaro_tpu_torch.kernels.radial import cp_ring_wedge  # noqa: E402
from saguaro_tpu_torch.kernels.shape_extra import _edt_sweep_inputs  # noqa: E402

BUILD = ROOT / "saguaro_tpu_torch" / "_build" / "k5_k4r_variants"
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the parent's C interfaces (the kernels before the redesign)
PARENT_SIGNATURES = {
    "sag_edt_sweep": (_P, _P, _P, _I, _I, _I, _I, _P),
    "sag_radial_sums": (_P, _P, _P, _P, _I, _LL, _I, _I, _I, _P),
}
_OWN = ("sag_edt_sweep", "sag_edt_sweep_info", "sag_radial_sums", "sag_radial_info")
_P5_CAND = "      const float cand = fminf(c[-dx], c[dx]) + (float)(dx * dx);"
_P4_ROUND_ADD = "      if (lane == leader) atomicAdd(dst, (float)__popc(members));"
_P4_CH_ADD = "          if (lane == leader) atomicAdd(dst + 1 + c, s);"
_P4_BALLOT = "    unsigned todo = __ballot_sync(SAG_FULL_MASK, act);"
_B4_ATOMIC = "  for (int k = 0; k < NV; ++k) atomicAdd(dst + k, s[k]);"
# text patches: (source "parent" or "base", file, [(old, new), ...])
PATCHES = {
    # the parent's K5 with its candidates from registers (no shared load in
    # the loop), with one integer op a step instead of its arithmetic, and
    # with no sweep at all (staging, d2 and the stores)
    "p_k5_noshared": ("parent", "edt_sweep.cu", [
        ("    const float* c = row_sh + radius + x;\n",
         "    const float* c = row_sh + radius + x;\n    const float c0 = c[-1], c1 = c[1];\n"),
        (_P5_CAND, "      const float cand = fminf(c0, c1 - (float)dx) + (float)(dx * dx);")]),
    "p_k5_noarith": ("parent", "edt_sweep.cu", [
        (_P5_CAND + "\n      best = fminf(best, cand);",
         "      best = __int_as_float(__float_as_int(best) ^ __float_as_int(c[-dx]) ^ "
         "__float_as_int(c[dx]));")]),
    "p_k5_nosweep": ("parent", "edt_sweep.cu", [
        ("for (int dx = 1; dx <= radius; ++dx)", "for (int dx = 1; dx <= 0; ++dx)")]),
    # the parent's K4 radial without its atomics, with one round a warp
    # step (the leader's key only), and with its loads alone
    "p_k4r_noatomic": ("parent", "radial_sums.cu", [
        (_P4_ROUND_ADD, _P4_ROUND_ADD.replace("lane == leader", "lane == leader && k0 == -7")),
        (_P4_CH_ADD, _P4_CH_ADD.replace("lane == leader", "lane == leader && s == -7.5f"))]),
    "p_k4r_norounds": ("parent", "radial_sums.cu", [
        ("      todo &= ~members;", "      todo = 0u;")]),
    "p_k4r_loads": ("parent", "radial_sums.cu", [
        (_P4_BALLOT, "    float sink = 0.0f;\n#pragma unroll\n    for (int c = 0; c < "
                     "SAG_RADIAL_MAX_CH; ++c) sink += v[c];\n    unsigned todo = "
                     "__ballot_sync(SAG_FULL_MASK, act && sink == -7.5f);")]),
    # this checkout's K5 with 4 steps a block (8 in the source), with 4
    # outputs a group and 4 steps a block, with 8-value block minima (32 in
    # the source), with 2 or 8 rows a CTA (4 in the source), through its
    # 4-byte path at every shape, without its early exit, with the exit
    # tested on the row's minimum instead of each group's reach, and with
    # no sweep at all
    "k5_s4": ("base", "edt_sweep.cu", [("#define K5_S 8 ", "#define K5_S 4 ")]),
    "k5_p4": ("base", "edt_sweep.cu", [("#define K5_P 8 ", "#define K5_P 4 "),
                                       ("#define K5_S 8 ", "#define K5_S 4 ")]),
    "k5_block8": ("base", "edt_sweep.cu", [("#define K5_BLOCK 32 ", "#define K5_BLOCK 8 ")]),
    "k5_warps2": ("base", "edt_sweep.cu", [("#define K5_WARPS 4 ", "#define K5_WARPS 2 ")]),
    "k5_warps8": ("base", "edt_sweep.cu", [("#define K5_WARPS 4 ", "#define K5_WARPS 8 ")]),
    "k5_4byte": ("base", "edt_sweep.cu", [
        ("  const bool vec = w % 4 == 0 &&", "  const bool vec = false && w % 4 == 0 &&")]),
    "k5_noexit": ("base", "edt_sweep.cu", [("  return done;\n}", "  return false;\n}")]),
    "k5_rowmin": ("base", "edt_sweep.cu", [
        ("gmin[g] = k5_reach_min(g, a.reff, kp, bmin);",
         "{ float m = bmin[0]; for (int bb = 1; bb < nb; ++bb) m = k5_min(m, bmin[bb]); "
         "gmin[g] = m; }")]),
    "k5_nosweep": ("base", "edt_sweep.cu", [
        ("  if (t.k >= n_blk) return true;", "  return true;")]),
    # this checkout's K4 radial with scalar reductions only, with plain
    # stores in place of the reductions, reading every vector's values (only
    # those with a pixel in a bin in the source), loading each iteration's
    # labels and codes at its start (the next iteration's are in flight in
    # the source), with 4 vectors in flight, and with its loads alone
    "k4r_scalar": ("base", "radial_sums.cu", [("  if (NV % 2 == 0) {", "  if (false) {")]),
    "k4r_store": ("base", "radial_sums.cu", [
        ("  if (NV % 2 == 0) {", "  if (false) {"),
        (_B4_ATOMIC, _B4_ATOMIC.replace("atomicAdd(dst + k, s[k])", "dst[k] = s[k]"))]),
    "k4r_noskip": ("base", "radial_sums.cu", [
        ("      const bool load = max(max(key[u][0], key[u][1]), max(key[u][2], key[u][3])) >= 0;",
         "      const bool load = v < v1;")]),
    "k4r_noprefetch": ("base", "radial_sums.cu", [
        ("  k4r_load_lc(lab4, code4, v0, v1, nl, nc);\n", ""),
        ("    k4r_load_lc(lab4, code4, base + step, v1, nl, nc);\n", ""),
        ("      lv[u] = nl[u];\n      cv[u] = nc[u];\n    }\n",
         "    }\n    k4r_load_lc(lab4, code4, base, v1, lv, cv);\n")]),
    "k4r_unroll4": ("base", "radial_sums.cu", [("#define K4R_UNROLL 2 ", "#define K4R_UNROLL 4 ")]),
    "k4r_loads": ("base", "radial_sums.cu", [
        ("    if (key[p] < 0) continue;",
         "    float sink = 0.0f;\n#pragma unroll\n"
         "    for (int c = 0; c < C; ++c) sink += v[p * C + c];"
         "\n    if (key[p] < 0 || sink != -7.5f) continue;")]),
}


def build(variants: dict[str, tuple[Path, dict]]) -> dict[str, ctypes.CDLL]:
    """For each variant name: edt_sweep.cu, radial_sums.cu and errors.cu of
    its source directory (PATCHES[name] applied) built alone, all builds
    started together, into a library bound with its signatures."""
    flags = [*sc._NVCC_FLAGS, "-shared"]
    files = ("edt_sweep.cu", "radial_sums.cu", "errors.cu")
    procs = {}
    for name, (src, _) in variants.items():
        out = BUILD / name
        out.mkdir(parents=True, exist_ok=True)
        _, patched, edits = PATCHES.get(name, (None, None, []))
        for f in ("common.cuh", *files):
            text = (src / f).read_text()
            for old, new in edits if f == patched else []:
                if text.count(old) != 1:
                    raise ValueError(f"variant {name}: patch target not found once: {old!r}")
                text = text.replace(old, new)
            (out / f).write_text(text)
        cmd = [sc._nvcc(), *flags, "-o", str(out / "lib.so"), *(str(out / f) for f in files)]
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
    rep = [r for r in cs.ptxas_report(log)
           if "sag_edt_sweep" in r["name"] or "sag_radial" in r["name"]]
    kernels = {n: {"registers": r["registers"], "spill": r["spill_stores"] + r["spill_loads"],
                   "smem": r["smem"]} for n, r in zip(cs.demangle([r["name"] for r in rep]), rep)}
    print(json.dumps({"variant": name, "build_s": round(secs, 1), "kernels": kernels}), flush=True)


def inputs(dev):
    """{row: ("k5", v2, d2, radius) or ("k4r", labels, codes, image, mc,
    n_codes)} at chip_smoke's shapes."""
    images, labels = cs.synthetic_sites(cs.N_SITES, cs.SIZE, seed=0)
    lab = torch.as_tensor(labels, device=dev)
    b, h, w = labels.shape
    n = h * w
    rows = {"k5 nuclei 8x1080^2 R64": ("k5", *_edt_sweep_inputs(lab), 64)}
    sparse = torch.as_tensor(cs.sparse_sites(cs.N_SITES, cs.SIZE, seed=3), device=dev)
    rows["k5 sparse 8x1080^2 R64"] = ("k5", *_edt_sweep_inputs(sparse), 64)
    g = torch.Generator(device=dev).manual_seed(5)
    odd = torch.randint(0, 3000, (2, 1001, 1537), generator=g, device=dev).float()
    rows["k5 odd 2x1001x1537 R48"] = ("k5", odd, odd + 700.0, 48)
    vr = torch.as_tensor(images.astype("float32"), device=dev).reshape(b, n, -1)
    rw = cp_ring_wedge(lab, cs.MAX_CELLS, 4, 64).reshape(b, n).to(torch.int32)
    rows["k4r nuclei 8x1166400x5"] = ("k4r", lab.reshape(b, n), rw, vr, cs.MAX_CELLS, 32)
    m = n - 3  # an odd pixel count: every site has a ragged head or tail
    rows["k4r 1ch odd 8x1166397x1"] = ("k4r", lab.reshape(b, n)[:, :m].contiguous(),
                                       rw[:, :m].contiguous(), vr[:, :m, :1].contiguous(),
                                       cs.MAX_CELLS, 32)
    return {k: tuple(t.contiguous() if isinstance(t, torch.Tensor) else t for t in v)
            for k, v in rows.items()}


def plain(row):
    if row[0] == "k5":
        return sc.edt_sweep_plain(*row[1:])
    return sc.radial_sums_plain(*row[1:], dtype=torch.float64)


def hold(name, got, row, want) -> bool:
    """Whether ``got`` agrees with the plain form ``want``."""
    if row[0] == "k5":
        return bool(torch.equal(got.isnan(), want.isnan())
                    and torch.equal(got.nan_to_num(), want.nan_to_num()))
    if not torch.equal(got[..., 0].double(), want[..., 0]):
        return False
    err = (got.double() - want).abs()
    return bool((err <= cs.SUM_RTOL * want.abs() + 1e-6).all())


def parent_call(lib, row):
    """The parent's launch on ``row``: (bare call, wrapper-like call, output)."""
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    if row[0] == "k5":
        _, v2, d2, radius = row
        b, h, w = v2.shape
        out = torch.empty_like(v2)

        def call(out=out):
            if lib.sag_edt_sweep(v2.data_ptr(), d2.data_ptr(), out.data_ptr(), b, h, w, radius,
                                 stream()) != 0:
                raise RuntimeError("parent sag_edt_sweep failed")

        return call, lambda: call(torch.empty_like(v2)), out
    _, lab, codes, img, mc, n_codes = row
    b, n = lab.shape
    n_ch = img.shape[2]
    out = torch.zeros((b, mc, n_codes, 1 + n_ch), device=lab.device)

    def call(out=out):
        if lib.sag_radial_sums(lab.data_ptr(), codes.data_ptr(), img.data_ptr(), out.data_ptr(),
                               b, n, n_ch, mc, n_codes, stream()) != 0:
            raise RuntimeError("parent sag_radial_sums failed")

    return call, lambda: call(torch.zeros_like(out)), out


def base_call(lib, row):
    """This checkout's bare launch on ``row`` through ``lib`` (the package's
    library, or a variant's): (call, output)."""
    saved, sc._LIB = sc._LIB, lib
    try:
        if row[0] == "k5":
            call, out = cs.edt_bare(*row[1:])
        else:
            call, out = cs.radial_bare(*row[1:])
    finally:
        sc._LIB = saved
    return call, out


def main() -> int:
    args = sys.argv[1:]
    parent = None
    if args[:1] == ["--parent"]:
        parent, args = Path(args[1]).resolve(), args[2:]
    names = args or ["parent", "base"]
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    libs = {}
    if "base" in names:
        t0 = time.perf_counter()
        lib = sc.build_kernels()
        libs["base"] = sc._lib()
        report("base", (lib.parent / "build.log").read_text(), time.perf_counter() - t0)
    csrc = ROOT / "saguaro_tpu_torch" / "csrc"
    own = {f: sc.SIGNATURES[f] for f in _OWN}

    def source(n):
        if n == "parent" or PATCHES.get(n, ("base",))[0] == "parent":
            return parent / "saguaro_tpu_torch" / "csrc", PARENT_SIGNATURES
        return csrc, own

    libs.update(build({n: source(n) for n in dict.fromkeys(names) if n != "base"}))

    rows = inputs(dev)
    wants = {r: plain(row) for r, row in rows.items()}
    if "base" in names:
        wrapped = {"variant": "wrappers (this checkout)"}
        for r, row in rows.items():
            fn = sc.seg_edt_sweep if row[0] == "k5" else sc.seg_radial_sums
            if not hold(r, fn(*row[1:]), row, wants[r]):
                raise AssertionError(f"{r}: this checkout's wrapper differs from the plain form")
            wrapped[r] = round(cs.time_ms(lambda: fn(*row[1:]), 20), 4)
        print(json.dumps(wrapped), flush=True)

    calls = {}
    for name in dict.fromkeys(names):
        is_parent = source(name)[1] is PARENT_SIGNATURES
        calls[name] = {}
        for r, row in rows.items():
            if is_parent:
                call, wrap, out = parent_call(libs[name], row)
            else:
                (call, out), wrap = base_call(libs[name], row), None
            out.zero_()
            call()
            torch.cuda.synchronize()
            ok = hold(r, out, row, wants[r])
            if not ok and name in ("parent", "base"):
                raise AssertionError(f"{name} {r} differs from the plain form")
            calls[name][r] = (call, wrap, ok)
        print(json.dumps({"variant": name, "agrees": {r: c[2] for r, c in calls[name].items()}}),
              flush=True)
    if "parent" in calls:
        row = {"variant": "parent wrapper (allocation + C call)"}
        for r, (_, wrap, _) in calls["parent"].items():
            row[r] = round(cs.time_ms(wrap, 20), 4)
        print(json.dumps(row), flush=True)
    for name in names + names[:1]:
        row = {"variant": name}
        for r, (fn, _, _) in calls[name].items():
            row[r] = round(cs.time_launches_ms(fn), 4)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
