"""On the card: the full-width CPnet (features 32-256, bf16, tile 224,
batch 8) trained on chip_smoke's 32 training tiles of ``synthetic_nuclei``
at each learning rate and seed given, 500 steps from tensors in memory;
each trained net then segments chip_smoke's 4 held-out tiles through the
engine. Prints the card's name and power limit, the flows' card-vs-CPU
difference, chip_smoke's 5-step card-vs-CPU training hold, and for each
run the first and last loss, the mean loss of each 50 steps, the median
s/step, peak memory and the held-out IoU.

    python3 tools/train_lr_sweep.py [--lr 1e-3 5e-3] [--seed 0 1]

About two minutes for the default four runs.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from saguaro_tpu_torch.models.cellpose import CellposeConfig  # noqa: E402
from saguaro_tpu_torch.models.cellpose_train import masks_to_flows, synthetic_nuclei, train_cellpose  # noqa: E402
from saguaro_tpu_torch.models.effnetv2 import EffNetV2Config, StageSpec  # noqa: E402
from saguaro_tpu_torch.pipeline.segment_embed import SegmentEmbedConfig, SegmentEmbedEngine  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lr", type=float, nargs="+", default=[1e-3, 5e-3])
    ap.add_argument("--seed", type=int, nargs="+", default=[0, 1])
    args = ap.parse_args()
    print(torch.__version__, torch.version.cuda, subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(51)   # chip_smoke.run_training's seed
    tiles = [synthetic_nuclei(rng, size=cs.TRAIN_TILE, n_cells=cs.TRAIN_NUCLEI)
             for _ in range(cs.TRAIN_PAIRS + cs.HELD_OUT)]
    raw = [(img[..., 0] * 1000).astype(np.uint16) for img, _ in tiles]
    labels = [lab for _, lab in tiles]
    flows = [masks_to_flows(lab, device=dev) for lab in labels]
    cpu = [masks_to_flows(lab, device="cpu") for lab in labels[:4]]
    print("flows card vs CPU, max abs", max(float(np.abs(a - b).max()) for a, b in zip(flows, cpu)), flush=True)
    cs.hold_training_against_cpu(dev)
    x = np.zeros((len(raw), cs.TRAIN_TILE, cs.TRAIN_TILE, 2), np.float32)
    for i, r in enumerate(raw):     # the CLI's normalisation of channel 0
        lo, hi = np.percentile(r.astype(np.float32), [1, 99])
        x[i, ..., 0] = (r - lo) / max(hi - lo, 1e-6)
    f, p = np.stack(flows), np.stack([(lab > 0).astype(np.float32) for lab in labels])
    n = cs.TRAIN_PAIRS
    tiny = EffNetV2Config(stem_filters=4, stages=(StageSpec("fused", 1, 3, 1, 4, 1),), head_filters=8)
    for lr in args.lr:
        for seed in args.seed:
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            r = train_cellpose(x[:n], f[:n], p[:n], CellposeConfig(tile=cs.TRAIN_TILE), n_steps=500,
                               batch_size=8, learning_rate=lr, seed=seed, device=dev)
            secs = time.perf_counter() - t0
            engine = SegmentEmbedEngine(SegmentEmbedConfig(channels=["DNA"], diameter=30.0, effnet=tiny),
                                        cellpose_state_dict=r.variables, device=dev)
            pred = [q.cpu().numpy() for q in engine.segment_batch(np.stack(raw[n:])[..., None])]
            losses = np.asarray(r.losses)
            print(json.dumps({
                "lr": lr, "seed": seed, "first_loss": float(losses[0]), "last_loss": float(losses[-1]),
                "window_means": [round(float(losses[i:i + 50].mean()), 4) for i in range(0, 500, 50)],
                "s_per_step": float(np.median(r.step_seconds[10:])), "train_s": secs,
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                "held_iou": float(np.mean([cs.iou_matched(g, q) for g, q in zip(labels[n:], pred)])),
                "objects": [int(q.max()) for q in pred], "placed": [int(g.max()) for g in labels[n:]]}),
                flush=True)


if __name__ == "__main__":
    main()
