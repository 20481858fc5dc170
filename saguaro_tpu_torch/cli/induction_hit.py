"""CLI: induction-score hit calling (reference
Inuction_Score_hit.py:250-267 — flags preserved; port of
``saguaro_tpu/cli/induction_hit.py``, plus ``--device``)."""

import argparse
import logging


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Bioactivity analysis with per-plate normalization, "
        "Venn diagrams, and heatmaps."
    )
    parser.add_argument("--bucket_name", required=True,
                        help="Bucket with feature and platemap files.")
    parser.add_argument("--features_key", required=True,
                        help="Key to the normalized selected feature CSV.")
    parser.add_argument("--bioactive_threshold_quantile", type=float, default=0.95,
                        help="Quantile threshold for ZPE/DMSO induction.")
    parser.add_argument("--induction_threshold", type=float, default=0.95,
                        help="Threshold to consider a feature induced.")
    parser.add_argument("--output_prefix", required=True,
                        help="Prefix where output images will be saved.")
    parser.add_argument("--DMSO", type=str, default="DMSO",
                        help="DMSO nomenclature used in the plateMap.")
    parser.add_argument("--device", type=str, default=None,
                        help="Torch device (default: CUDA; 'cpu' runs the plain forms).")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(asctime)s - %(levelname)s - %(message)s")
    from saguaro_tpu_torch.pipeline.hits import run_induction_hit

    return run_induction_hit(
        bucket_name=args.bucket_name,
        features_key=args.features_key,
        output_prefix=args.output_prefix,
        bioactive_threshold_quantile=args.bioactive_threshold_quantile,
        induction_threshold=args.induction_threshold,
        dmso=args.DMSO,
        device=args.device,
    )


if __name__ == "__main__":
    main()
