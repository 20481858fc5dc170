"""Times K6 (``csrc/pick2.cu``, the rank pick) on one NVIDIA GPU, a parent
checkout's kernel beside this one's, at chip_smoke's shape (the dense-rank
tables of its three object sets: 8 sites of 1,166,400 pixels, 5 channels,
3 sets) and at every shape of the card tests (``tests/torch_data.
pick2_case``: 1, 2, 5 and 8 channels by 1-4 sets, odd N, codes outside
[0, 256) on both sides).

    python3 tools/k6_variants.py [--parent CHECKOUT] [variant ...]

Variants: ``base``, this checkout's kernel through the package's plan;
``parent``, the ``pick2.cu`` of CHECKOUT (unpack the commit with ``git
archive`` into a git-ignored directory) built alone with the package's
nvcc flags under saguaro_tpu_torch/_build/k6_variants/ and called through
its own C interface (a (B, N, C, K) output, one launch); the names of
PATCHES, text patches of this checkout's source or (``p_*``) of the
parent's, built alone and called as ``base`` or ``parent`` (some compute
wrong results and are timed only); any of them with ``@m<N>`` or
``@wave``, a launch plan other than the package's (``_plan_for``).
Each variant is held against
``pick2_plain`` with ``torch.equal``, and the timing-only ones report
whether they still agree. Every variant is timed bare (the C call alone,
back to back, with plans and outputs made beforehand:
``chip_smoke.time_launches_ms``), in the order given, the first again
last, and then by its kernels' device time in a torch.profiler trace
(at the card tests' shapes a bare launch is shorter than its host
call). With ``base`` among them, this checkout's wrapper is timed once as
chip_smoke times it (``chip_smoke.time_ms``); with ``parent``, the
parent's C call with its output allocated, as its wrapper did. Prints the
card's name and power limit, the variants' registers and spills, then one
JSON line a timing row."""

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
from tests.torch_data import PICK2_CASES, pick2_case  # noqa: E402

BUILD = ROOT / "saguaro_tpu_torch" / "_build" / "k6_variants"
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the parent's C interface (the kernel before the redesign)
PARENT_SIGNATURES = {"sag_pick2": (_P, _P, _P, _P, _I, _LL, _I, _I, _P)}
_OWN = ("sag_pick2", "sag_pick2_info")
_P6_STORE = ("    for (int k = 0; k < k_tab; ++k) out_site[(size_t)j * k_tab + k] = ok ? "
             "__ldg(row + k) : 0.0f;")
# text patches: (source "parent" or "base", [(old, new), ...]) of pick2.cu
PATCHES = {
    # the split reading of the parent's kernel: a 32-bit channel index; the
    # table gather replaced by a constant (the code and rank streams alone);
    # the stores dropped (the codes and gathers alone); the codes alone; and
    # no cap on the grid (a CTA an item block)
    "p_k6_c32": ("parent", [("    const int c = (int)(j % n_ch);",
                             "    const int c = (int)((unsigned)j % (unsigned)n_ch);")]),
    "p_k6_const": ("parent", [(_P6_STORE, _P6_STORE.replace("__ldg(row + k)", "(float)k"))]),
    "p_k6_nostore": ("parent", [(_P6_STORE,
                                 "    float s = 0.0f;\n    for (int k = 0; k < k_tab; ++k) s += ok ? "
                                 "__ldg(row + k) : 0.0f;\n    if (s == -7.5f) out_site[j] = s;")]),
    "p_k6_codes": ("parent", [(_P6_STORE, "    if (h + l == -77777 && c == 3) out_site[j] = 1.0f;")]),
    "p_k6_nocap": ("parent", [("  long long cap = (4096 + batch - 1) / batch;",
                               "  long long cap = blocks;")]),
    # this checkout's kernel: loading a thread's next vector of codes only
    # after the current one's stores (the source loads it before its
    # gathers), with plain loads and stores (streamed in the source), with
    # 128-thread CTAs, and with the gathers replaced by a constant (the
    # streams alone)
    "k6_noprefetch": ("base", [(
        "    int4 hn, ln;\n    if (un < u1) {\n      hn = __ldcs(hv + un);\n"
        "      ln = __ldcs(lv + un);\n    }\n", ""), (
        "    h = hn;\n    l = ln;\n", "    h = __ldcs(hv + u);\n    l = __ldcs(lv + u);\n")]),
    "k6_nohint": ("base", [
        ("  int4 h = __ldcs(hv + u), l = __ldcs(lv + u);", "  int4 h = __ldg(hv + u), l = __ldg(lv + u);"),
        ("      hn = __ldcs(hv + un);\n      ln = __ldcs(lv + un);",
         "      hn = __ldg(hv + un);\n      ln = __ldg(lv + un);"),
        ("    __stcs(reinterpret_cast<float4*>(o + k * a.plane),\n           make_float4(",
         "    *reinterpret_cast<float4*>(o + k * a.plane) = (\n           make_float4(")]),
    "k6_t128": ("base", [("#define K6_THREADS 256", "#define K6_THREADS 128")]),
    "k6_const": ("base", [("  for (int k = 0; k < KC; ++k) v[k] = ok ? __ldg(row + k) : 0.0f;",
                           "  for (int k = 0; k < KC; ++k) v[k] = ok ? (float)k : 0.0f;")]),
}


def build(variants: dict[str, tuple[Path, dict]]) -> dict[str, ctypes.CDLL]:
    """For each variant name: pick2.cu and errors.cu of its source directory
    (PATCHES[name] applied to pick2.cu) built alone, all builds started
    together, into a library bound with its signatures."""
    flags = [*sc._NVCC_FLAGS, "-shared"]
    files = ("pick2.cu", "errors.cu")
    procs = {}
    for name, (src, _) in variants.items():
        out = BUILD / name
        out.mkdir(parents=True, exist_ok=True)
        edits = PATCHES.get(name, (None, []))[1]
        for f in ("common.cuh", *files):
            text = (src / f).read_text()
            for old, new in edits if f == "pick2.cu" else []:
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
    rep = [r for r in cs.ptxas_report(log) if "sag_pick2" in r["name"]]
    kernels = {n: {"registers": r["registers"], "spill": r["spill_stores"] + r["spill_loads"]}
               for n, r in zip(cs.demangle([r["name"] for r in rep]), rep)}
    print(json.dumps({"variant": name, "build_s": round(secs, 1), "kernels": kernels}), flush=True)


def inputs(dev):
    """{row: (hi, lo, tables)} at chip_smoke's shape and the card tests'."""
    images, labels = cs.synthetic_sites(cs.N_SITES, cs.SIZE, seed=0)
    img = torch.as_tensor(images.astype("float32"), device=dev)
    lab = torch.as_tensor(labels, device=dev)
    hi, lo, tables = cs.rank_pick_inputs(img, lab)[:3]
    rows = {f"k6 {tuple(hi.shape)} K{tables.shape[4]}": (hi, lo, tables)}
    del img, lab
    for n_ch, k in PICK2_CASES:
        case = tuple(torch.from_numpy(a).to(dev) for a in pick2_case(n_ch, k, seed=8 * n_ch + k))
        rows[f"card {tuple(case[0].shape)} K{k}"] = case
    return rows


def parent_call(lib, row):
    """The parent's launch on ``row``: (bare call, wrapper-like call, output)."""
    hi, lo, tables = row
    b, n, n_ch = hi.shape
    k = tables.shape[4]
    out = torch.empty((b, n, n_ch, k), device=hi.device)

    def call(out=out):
        if lib.sag_pick2(hi.data_ptr(), lo.data_ptr(), tables.data_ptr(), out.data_ptr(), b, n, n_ch,
                         k, torch.cuda.current_stream().cuda_stream) != 0:
            raise RuntimeError("parent sag_pick2 failed")

    return call, lambda: call(torch.empty_like(out)), out


def _plan_for(mode: str, k: int):
    """``pick2_plan``, or (``mode``) a launch-plan override of it: ``m<N>``,
    N vectors a thread (N * K6_THREADS a CTA; the package's plan is m2);
    ``wave``, one wave of the CTAs the card holds resident, split over the
    sites, each over a contiguous range (K3's kind of plan; the residency
    of the kernel of ``k`` sets)."""
    plan = sc.pick2_plan
    if not mode:
        return plan

    def override(b, n, n_ch):
        plan(b, n, n_ch)  # its raises
        n_vec = n * n_ch // 4
        if mode == "wave":
            per_sm = sc.pick2_kernel_info(min(k, sc.K6_MAX_KC))
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            ctas = max(1, min(-(-sms * per_sm["ctas_per_sm"] // b), -(-n_vec // sc.K6_CTA_VECS)))
        else:
            ctas = max(1, -(-n_vec // (int(mode[1:]) * sc.K6_THREADS)))
        return sc.Pick2Plan(ctas, -(-n_vec // ctas))

    return override


def base_call(lib, row, mode=""):
    """This checkout's bare launch on ``row`` through ``lib`` (the package's
    library, or a variant's), by the package's plan or ``mode``'s override:
    (call, output)."""
    saved = sc._LIB, sc.pick2_plan
    sc.pick2_kernel_info.cache_clear()
    sc._LIB, sc.pick2_plan = lib, _plan_for(mode, row[2].shape[4])
    try:
        return cs.pick2_bare(*row)
    finally:
        sc._LIB, sc.pick2_plan = saved
        sc.pick2_kernel_info.cache_clear()


def device_ms(fn, reps: int = 20) -> float:
    """The mean device time of ``fn``'s kernels a call, from a torch.profiler
    trace of ``reps`` calls after two warm-up calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / reps


def main() -> int:
    args = sys.argv[1:]
    parent = None
    if args[:1] == ["--parent"]:
        parent, args = Path(args[1]).resolve(), args[2:]
    names = args or ["parent", "base"]
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    lib_of = {n: n.partition("@")[0] for n in names}  # "variant@mode": a plan override
    libs = {}
    if "base" in lib_of.values():
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

    libs.update(build({v: source(v) for v in dict.fromkeys(lib_of.values()) if v != "base"}))

    rows = inputs(dev)
    wants = {r: sc.pick2_plain(*row) for r, row in rows.items()}
    if "base" in libs:
        wrapped = {"variant": "wrapper (this checkout)"}
        for r, row in rows.items():
            if not torch.equal(sc.seg_pick2(*row), wants[r]):
                raise AssertionError(f"{r}: this checkout's wrapper differs from the plain form")
            wrapped[r] = round(cs.time_ms(lambda: sc.seg_pick2(*row), 20), 4)
        print(json.dumps(wrapped), flush=True)

    calls = {}
    for name in dict.fromkeys(names):
        lib = libs[lib_of[name]]
        is_parent = source(lib_of[name])[1] is PARENT_SIGNATURES
        calls[name] = {}
        for r, row in rows.items():
            if is_parent:
                call, wrap, out = parent_call(lib, row)
            else:
                (call, out), wrap = base_call(lib, row, name.partition("@")[2]), None
            out.zero_()
            call()
            torch.cuda.synchronize()
            ok = bool(torch.equal(out, wants[r]))
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
    # the kernels' own device time, traced: at the card tests' shapes a
    # bare launch is shorter than its host call, so the rows above time the
    # host there
    for name in names + names[:1]:
        row = {"variant": f"{name} (traced device time)"}
        for r, (fn, _, _) in calls[name].items():
            row[r] = round(device_ms(fn), 4)
        print(json.dumps(row), flush=True)
    # what PyTorch's own streams reach on this card at chip_smoke's bytes:
    # its ranks written alone, and a copy of the same bytes read and written
    hi = next(iter(rows.values()))[0]
    ranks = torch.empty((3, hi.numel()), device=dev)
    src = torch.empty(((hi.numel() * 20) // 8,), device=dev)
    dst = torch.empty_like(src)
    print(json.dumps({"variant": "PyTorch streams", f"fill_ of {ranks.numel() * 4} B": round(
        cs.time_launches_ms(lambda: ranks.fill_(1.0)), 4), f"copy_ of {src.numel() * 4} B": round(
        cs.time_launches_ms(lambda: dst.copy_(src)), 4)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
