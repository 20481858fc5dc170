"""measure_site_batch seconds per site at chip_smoke's inputs (8 sites of
1080 x 1080 x 5 channels, the default FeatureConfig) from the checkout
given, four calls in one process on one NVIDIA GPU: the first call's and
the warm calls' times, for comparing two commits on one card.

    python3 tools/measure_ab.py PATH_TO_CHECKOUT

Unpack the other commit with ``git archive`` into a git-ignored directory
and run parent, change, change, parent on one card."""

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
print(json.dumps({"checkout": tree, "build_s": round(build_s, 1), "measure_s_per_site": times}))
