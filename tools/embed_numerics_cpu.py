"""Why chip_smoke's embed and CLI phases are built as they are, on the CPU.

    python3 tools/embed_numerics_cpu.py

Prints, at chip_smoke's full widths on two of its 1080² synthetic sites:
1. the masks a random CPnet (seed 0, head scaled 1x and 30x) finds with
   and without cellpose's flow QC at 0.4, and what ``gradient_cpnet``
   finds on ``cone_sites``;
2. the scale of EfficientNetV2-L's features with identity BatchNorm
   statistics and after ``calibrated_effnet``;
3. with calibrated statistics, the growth of a 1e-6 input perturbation
   through L in f32, and the cosine between each crop's bf16 and f32
   embeddings beside the cosine between two crops' f32 embeddings (the
   quantities chip_smoke's bf16 check compares), at 480² on 8 crops.
Takes a few minutes on 8 cores.
"""

from __future__ import annotations

import copy
import dataclasses
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from saguaro_tpu_torch.kernels.crops import in_bounds, label_centroids  # noqa: E402
from saguaro_tpu_torch.models.effnetv2 import (  # noqa: E402
    EFFNETV2_L,
    EffNetV2Config,
    StageSpec,
    fold_batchnorm,
    fold_rgb_stem,
    init_effnetv2,
    preprocess_crops,
)
from saguaro_tpu_torch.pipeline.segment_embed import SegmentEmbedConfig, SegmentEmbedEngine  # noqa: E402

TINY = EffNetV2Config(stem_filters=4, stages=(StageSpec("fused", 1, 3, 1, 4, 1),), head_filters=1280)


def masks(engine, images, qc):
    engine.cfg.flow_error_threshold = 0.4 if qc else None
    out = []
    for lab in engine.segment_batch(images):
        cy, cx, cnt = label_centroids(lab, engine.cfg.max_cells)
        out.append((int(lab.max()), int(((cnt > 0) & in_bounds(cy, cx, *lab.shape, cs.BOX)).sum())))
    return out


def main():
    images, gt = cs.synthetic_sites(2, cs.SIZE, seed=0)
    cfg = SegmentEmbedConfig(channels=list(cs.CHANNELS), effnet=TINY)
    for scale in (1.0, 30.0):
        engine = SegmentEmbedEngine(cfg, device="cpu")
        with torch.no_grad():
            engine.cell_model.output[2].weight.mul_(scale)
        print(f"random CPnet, head x{scale:g}: (masks, passing the edge rule) a site without QC "
              f"{masks(engine, images, False)}, with QC 0.4 {masks(engine, images, True)}")
    cones, _ = cs.cone_sites(2, cs.SIZE, seed=12)
    engine = SegmentEmbedEngine(cfg, cellpose_state_dict=cs.gradient_cpnet(cfg.cellpose), device="cpu")
    print(f"gradient_cpnet on cone_sites, with QC 0.4: {masks(engine, cones, True)}")

    crops = cs.path_crops(images, gt, "cpu", 8)
    x = preprocess_crops(crops, cs.EMBED_SIZE, n_channels=1)
    f32_cfg = dataclasses.replace(EFFNETV2_L, compute_dtype="float32")
    with torch.no_grad():
        plain = fold_rgb_stem(fold_batchnorm(init_effnetv2(f32_cfg, seed=0, device="cpu")))
        print(f"identity BatchNorm statistics: largest |feature| {float(plain(x).abs().max()):.3g}")
        model = init_effnetv2(f32_cfg, device="cpu")
        model.load_state_dict(cs.calibrated_effnet(images, gt, "cpu"))
        f32 = fold_rgb_stem(fold_batchnorm(model))
        want = f32(x)
        print(f"calibrated statistics: largest |feature| {float(want.abs().max()):.3g}")
        noise = 1e-6 * torch.randn(x.shape, generator=torch.Generator().manual_seed(0))
        grown = (f32(x + noise) - want).norm() / want.norm() / (noise.norm() / x.norm())
        print(f"a 1e-6 input perturbation, relative: grown {float(grown):.1f}x through L")
        bf16 = copy.deepcopy(f32)
        bf16.config = dataclasses.replace(bf16.config, compute_dtype="bfloat16")
        got = bf16(x).float()
    cos = torch.nn.functional.cosine_similarity(got, want, dim=1)
    unit = torch.nn.functional.normalize(want, dim=1)
    cross = (unit @ unit.T)[~torch.eye(len(unit), dtype=torch.bool)]
    print(f"bf16 vs f32 cosine {float(cos.min()):.4f}-{float(cos.max()):.4f}; two crops' f32 "
          f"embeddings {float(cross.min()):.4f}-{float(cross.max()):.4f}")


if __name__ == "__main__":
    main()
