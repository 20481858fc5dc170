"""CLI: segmentation + embedding pipeline (port of
``saguaro_tpu/cli/segment_embed.py``; the reference's
Cellpose_GPU_s3fs.py:476-494 flags, all kept, plus ``--device``)."""

import argparse
import logging


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Run cell image analysis pipeline: image-level QC filter, "
        "U-Net segmentation + flow mask recovery, per-channel embedding "
        "extraction, optional dead-cell classification."
    )
    parser.add_argument("--bucket_input", type=str, required=True,
                        help="Base input bucket where the intermediary results lie")
    parser.add_argument("--data_base_path", type=str, required=True,
                        help="Base path where the images are stored, e.g. /home/storage/Images")
    parser.add_argument("--num_consumers", type=int, default=2,
                        help="Kept for flag parity; one controller feeds the device.")
    parser.add_argument("--max_workers", type=int, default=24,
                        help="Host prefetch threads (the producer role).")
    parser.add_argument("--load_data_key", type=str, required=True,
                        help="Path to the load data file")
    parser.add_argument("--csv_image_key", type=str, required=False,
                        help="Path to the Image data file with QC annotations")
    parser.add_argument("--channels", nargs="+", type=str, required=True,
                        help="Channel prefixes as in the load data; first 3 used for segmentation")
    parser.add_argument("--out_data_path", type=str, required=True,
                        help="Path to the folder/file prefix for outputs (.parquet)")
    parser.add_argument("--single_cell", action="store_true", help="Activates single cell output")
    parser.add_argument("--save_coords", action="store_true", help="Store cell coordinates.")
    parser.add_argument("--xgb_model_path", type=str, default=None,
                        help="Path to XGBoost json model to classify cells.")
    parser.add_argument("--filter_dead_cells", action="store_true",
                        help="Exclude dead cells from the aggregation.")
    parser.add_argument("--diameter", type=float, default=100.0,
                        help="Median object diameter in px (reference eval setting).")
    parser.add_argument("--max_cells", type=int, default=512,
                        help="Static per-site cell bound.")
    parser.add_argument("--cellpose_checkpoint", type=str, default=None,
                        help="cellpose CPnet checkpoint: the package's own format "
                             "(train_segmenter's) or a torch file.")
    parser.add_argument("--effnet_checkpoint", type=str, default=None,
                        help="EfficientNetV2 checkpoint: the package's own format or a timm "
                             "or transformers torch file.")
    parser.add_argument("--spill_dir", type=str, default=None,
                        help="Per-site npz spill + manifest for resumable runs.")
    parser.add_argument("--devices", type=int, default=None,
                        help="Number of devices; only one (or unset) is ported.")
    parser.add_argument("--device", type=str, default=None,
                        help="Torch device (default: CUDA; 'cpu' runs the plain forms).")
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s - %(levelname)s - [%(name)s] - %(message)s",
    )
    from saguaro_tpu_torch.io import storage
    from saguaro_tpu_torch.io.loaddata import load_illum_functions
    from saguaro_tpu_torch.pipeline.pixel_stages import bucket_path
    from saguaro_tpu_torch.pipeline.segment_embed import SegmentEmbedConfig, run_pipeline

    cfg = SegmentEmbedConfig(
        channels=list(args.channels),
        diameter=args.diameter,
        max_cells=args.max_cells,
        prefetch_workers=args.max_workers,
        filter_dead_cells=args.filter_dead_cells,
        save_coords=args.save_coords,
        single_cell=args.single_cell,
        xgb_model_path=args.xgb_model_path,
        cellpose_checkpoint=args.cellpose_checkpoint,
        effnet_checkpoint=args.effnet_checkpoint,
        devices=args.devices,
    )
    load_data = storage.read_csv_sniffed(bucket_path(args.bucket_input, args.load_data_key))
    image_qc = illum = None
    if args.csv_image_key:
        image_qc = storage.read_csv_sniffed(storage.join(args.csv_image_key, "Image.csv"))
        illum = load_illum_functions(args.csv_image_key, args.channels)

    outputs = run_pipeline(
        load_data, args.data_base_path, cfg, args.out_data_path,
        image_qc=image_qc, illum=illum, spill_dir=args.spill_dir, device=args.device,
    )
    for kind, path in outputs.items():
        logging.info("%s -> %s", kind, path)
    return outputs


if __name__ == "__main__":
    main()
