"""Feature-extraction job seconds at chip_smoke's job-grid inputs from the
checkout given: 16 sites of 1080 x 1080 x 5 cone-shaped nuclei
(``chip_smoke.cone_sites``) written as LZW TIFFs, the full-width engine with
``chip_smoke.gradient_cpnet``'s CPnet, the default FeatureConfig, two
batches of 8. ``run_feature_extraction_job`` runs three times in one
process on one NVIDIA GPU (the first call warms up); prints one JSON line
with each call's seconds and sites/s, the card's name and power limit.

    python3 tools/job_ab.py PATH_TO_CHECKOUT

Unpack the other commit with ``git archive`` into a git-ignored directory
and run parent, change, change, parent on one card: the job's TIFF reads,
segmentation, measurement and table building are timed end to end, as a
user's job runs them, whichever job code and TIFF codec the checkout has."""

import json
import os
import subprocess
import sys
import tempfile
import time

tree = os.path.abspath(sys.argv[1])
sys.path.insert(0, tree)
os.chdir(tree)

import pandas as pd  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from saguaro_tpu_torch.io import tiff  # noqa: E402
from saguaro_tpu_torch.kernels import segment_cuda as sc  # noqa: E402
from saguaro_tpu_torch.models.cellpose import CellposeConfig  # noqa: E402
from saguaro_tpu_torch.pipeline.feature_extraction import run_feature_extraction_job  # noqa: E402
from saguaro_tpu_torch.pipeline.segment_embed import (  # noqa: E402
    SegmentEmbedConfig,
    SegmentEmbedEngine,
)

N_SITES = 16
dev = torch.device("cuda", 0)
torch.backends.cuda.matmul.allow_tf32 = False
sc.build_kernels()
sc._lib()
engine = SegmentEmbedEngine(SegmentEmbedConfig(channels=list(cs.CHANNELS)),
                            cellpose_state_dict=cs.gradient_cpnet(CellposeConfig()), seed=0,
                            device=dev)
images, _ = cs.cone_sites(N_SITES, cs.SIZE, seed=21)
secs, cells = [], []
with tempfile.TemporaryDirectory() as root:
    os.makedirs(os.path.join(root, "Images"))
    rows = []
    for s in range(N_SITES):
        row = {"Metadata_Plate": "P1", "Metadata_Well": f"A{s + 1:02}", "Metadata_Site": 1}
        for c, ch in enumerate(cs.CHANNELS):
            name = f"A{s + 1:02}_s1_{ch}.tiff"
            tiff.imwrite(os.path.join(root, "Images", name), images[s, ..., c], compression="lzw")
            row[f"FileName_{ch}"] = name
        rows.append(row)
    for k in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        written = run_feature_extraction_job(
            pd.DataFrame(rows), os.path.join(root, "Images"), os.path.join(root, f"out{k}"),
            list(cs.CHANNELS), engine, feature_cfg=cs.feature_config(), device=dev)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        cells.append(int(len(pd.read_csv(written["Nuclei"]))))
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
print(json.dumps({"tree": tree, "card": smi, "sites": N_SITES, "seconds": secs,
                  "sites_per_s": [N_SITES / t for t in secs], "nuclei": cells}))
