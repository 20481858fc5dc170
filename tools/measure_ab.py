"""measure_site_batch seconds per site at chip_smoke's inputs (8 sites of
1080 x 1080 x 5 channels, the default FeatureConfig) from the checkout
given, four calls in one process on one NVIDIA GPU: the first call's and
the warm calls' times, for comparing two commits on one card.

    python3 tools/measure_ab.py PATH_TO_CHECKOUT [--ranges]

Unpack the other commit with ``git archive`` into a git-ignored directory
and run parent, change, change, parent on one card. With ``--ranges``, one
more call under torch.profiler gives each ``measure/<family>`` range's
kernel ms, PyTorch's apart from the port's (``sag_*``) and the port's
launches that the trace puts inside no range: the same reading for any
checkout, whichever way it links its kernels to the ranges."""

import json
import os
import sys
import time

tree = os.path.abspath(sys.argv[1])
sys.path.insert(0, tree)
os.chdir(tree)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from saguaro_tpu_torch.kernels import segment_cuda as sc  # noqa: E402
from saguaro_tpu_torch.pipeline.features import measure_site_batch  # noqa: E402


def ranges(run) -> dict:
    """{range: [PyTorch's kernel ms, its launches, the port's kernel ms,
    its launches]} of one traced ``run``, by this checkout's
    ``chip_smoke.trace_ranges`` (nested ranges in each that encloses them),
    and the port's launches outside every range under "outside"."""
    import importlib.util

    from torch.profiler import ProfilerActivity, profile

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_reader", os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                                          "chip_smoke.py"))
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    by_range, port_all, inside = reader.trace_ranges(prof)
    out = {k: [round(v[0] / 1e3, 4), v[1], round(v[2] / 1e3, 4), v[3]] for k, v in by_range.items()}
    out["outside"] = port_all - inside
    return out


t0 = time.perf_counter()
sc.build_kernels()
sc._lib()
build_s = time.perf_counter() - t0
images, gt = cs.synthetic_sites(cs.N_SITES, cs.SIZE, seed=0)
times = []
for _ in range(4):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    measure_site_batch(images, gt, cs.feature_config(), device="cuda")
    torch.cuda.synchronize()
    times.append((time.perf_counter() - t0) / cs.N_SITES)
res = {"checkout": tree, "build_s": round(build_s, 1), "measure_s_per_site": times}
if "--ranges" in sys.argv[2:]:
    res["ranges_ms"] = ranges(
        lambda: measure_site_batch(images, gt, cs.feature_config(), device="cuda"))
print(json.dumps(res))
