"""CLI: classical feature extraction over a (plate x time) job grid (port of
``saguaro_tpu/cli/feature_extraction.py``; the reference's flags, plus
``--device``).

Each job segments its sites with the CPnet engine and measures the
CP-equivalent tables on one device, or sharded over ``--devices`` GPUs,
writing Image/Nuclei/Cells/Cytoplasm.csv under ``<output>/<plate>/<time>/``.
"""

import argparse
import logging


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Run CP-equivalent feature extraction for each "
        "(plate, time) job, writing Image/Nuclei/Cells/Cytoplasm.csv "
        "under <output>/<plate>/<time>/."
    )
    parser.add_argument("--bucket_name", required=True, help="Bucket with images + LoadData CSVs.")
    parser.add_argument("--base_output_path", required=True, help="Output bucket/prefix.")
    parser.add_argument("--plates", nargs="+", required=True, help="Plate tokens, e.g. P01 P02.")
    parser.add_argument("--times", nargs="+", default=["6", "12", "24", "48"],
                        help="Timepoints (hours).")
    parser.add_argument("--channels", nargs="+", required=True, help="Channel names.")
    parser.add_argument("--image_path_template", required=True,
                        help="Per-job image dir, e.g. '{folder}/{time}h_{plate}/Image'.")
    parser.add_argument("--load_data_template", required=True,
                        help="Per-job LoadData key, e.g. 'load_data_{plate}_{time}_illum.csv'.")
    parser.add_argument("--diameter", type=float, default=100.0)
    parser.add_argument("--max_cells", type=int, default=512)
    parser.add_argument("--devices", type=int, default=None,
                        help="Mesh size: shard segmentation + measurement batches "
                        "over this many GPUs (default, and 1: one device; sharding "
                        "has not yet been measured faster).")
    parser.add_argument("--device", type=str, default=None,
                        help="Torch device (default: CUDA; 'cpu' runs the plain forms).")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    from saguaro_tpu_torch.parallel.mesh import default_mesh_for
    from saguaro_tpu_torch.pipeline.feature_extraction import run_batch_processing
    from saguaro_tpu_torch.pipeline.features import FeatureConfig
    from saguaro_tpu_torch.pipeline.segment_embed import SegmentEmbedConfig, SegmentEmbedEngine

    mesh = default_mesh_for(args.device, args.devices) if args.devices else None
    engine = SegmentEmbedEngine(
        SegmentEmbedConfig(channels=list(args.channels), diameter=args.diameter,
                           max_cells=args.max_cells),
        device=args.device, mesh=mesh,
    )
    return run_batch_processing(
        bucket_name=args.bucket_name,
        base_output_path=args.base_output_path,
        plates=args.plates,
        times=args.times,
        channels=list(args.channels),
        image_path_for_job=lambda p, t: args.image_path_template.format(plate=p, time=t),
        load_data_key_for_job=lambda p, t: args.load_data_template.format(plate=p, time=t),
        segmenter=engine,  # exposes segment_batch: a chunk segments at once
        feature_cfg=FeatureConfig(channels=tuple(args.channels), max_cells=args.max_cells),
        device=args.device,
        mesh=mesh,
    )


if __name__ == "__main__":
    main()
