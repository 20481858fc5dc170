"""CLI: train the segmentation U-Net from labelled (image, mask) pairs (port
of ``saguaro_tpu/cli/train_segmenter.py``, with the reference's flags plus
``--device``).

The reference relies on a downloaded cellpose checkpoint; this package can
make its own: point ``--data_dir`` at paired TIFFs (``<name>.tiff`` +
``<name>_masks.tiff``); ground-truth flows come from heat diffusion, and
the network trains on the device. The result is a checkpoint in the JAX
package's format, which ``--cellpose_checkpoint`` of either package's
segment CLIs loads.
"""

import argparse
import logging


def main(argv=None):
    """Returns (the ``TrainResult``, the ``StageTimer`` of its stages: read,
    flows, train, save)."""
    parser = argparse.ArgumentParser(description="Train the Cellpose-style U-Net.")
    parser.add_argument("--data_dir", required=True,
                        help="Directory of <name>.tiff + <name>_masks.tiff pairs.")
    parser.add_argument("--output", required=True, help="Checkpoint output path.")
    parser.add_argument("--steps", type=int, default=500)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--learning_rate", type=float, default=1e-3)
    parser.add_argument("--tile", type=int, default=224)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default=None,
                        help="Torch device (default: CUDA; 'cpu' runs on the CPU).")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    import numpy as np

    from saguaro_tpu_torch.device import resolve_device
    from saguaro_tpu_torch.io import storage, tiff
    from saguaro_tpu_torch.models.cellpose import CellposeConfig
    from saguaro_tpu_torch.models.cellpose_train import masks_to_flows, train_cellpose
    from saguaro_tpu_torch.models.checkpoint import save_variables
    from saguaro_tpu_torch.utils.timing import StageTimer

    device = resolve_device(args.device)
    timer = StageTimer()
    pairs = []
    for path in storage.list_prefix(args.data_dir):
        if path.endswith("_masks.tiff") or path.endswith("_masks.tif"):
            continue
        if not path.lower().endswith((".tif", ".tiff")):
            continue
        stem = path.rsplit(".", 1)[0]
        for suffix in ("_masks.tiff", "_masks.tif"):
            mask_path = stem + suffix
            if storage.exists(mask_path):
                pairs.append((path, mask_path))
                break
    if not pairs:
        raise SystemExit(f"no (image, _masks) TIFF pairs under {args.data_dir}")
    logging.info("Found %d training pairs", len(pairs))

    images, flows, probs = [], [], []
    t = args.tile
    for img_path, mask_path in pairs:
        with timer.stage("read"):
            img = tiff.imread(img_path).astype(np.float32)
            if img.ndim == 2:
                img = np.stack([img, np.zeros_like(img)], axis=-1)
            labels = tiff.imread(mask_path).astype(np.int32)
            # crop/pad to the training tile
            img = img[:t, :t]
            labels = labels[:t, :t]
            pad = ((0, t - img.shape[0]), (0, t - img.shape[1]))
            img = np.pad(img, (*pad, (0, 0)))
            labels = np.pad(labels, pad)
            lo, hi = np.percentile(img[..., 0], [1, 99])
            img[..., 0] = (img[..., 0] - lo) / max(hi - lo, 1e-6)
        with timer.stage("flows"):
            flows.append(masks_to_flows(labels, device=device))
        images.append(img)
        probs.append((labels > 0).astype(np.float32))

    cfg = CellposeConfig(tile=args.tile)
    with timer.stage("train"):
        result = train_cellpose(
            np.stack(images), np.stack(flows), np.stack(probs), cfg,
            n_steps=args.steps, batch_size=args.batch_size,
            learning_rate=args.learning_rate, seed=args.seed, device=device,
        )
    logging.info("loss %.4f -> %.4f", result.losses[0], result.losses[-1])
    with timer.stage("save"):
        save_variables(args.output, result.variables, cfg)
    logging.info("Saved checkpoint to %s", args.output)
    timer.log_summary()
    return result, timer


if __name__ == "__main__":
    main()
