"""CLI: cross-plate feature selection + cosine (reference
Feature_select_cosine_ami.py:167-194 — flags preserved; port of
``saguaro_tpu/cli/feature_select_cosine.py``, plus ``--device``)."""

import argparse
import logging


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Concatenate normalized CellProfiler features, "
        "feature-select, double-sigmoid, and compute cosine similarity."
    )
    parser.add_argument("--bucket_name", type=str, required=True)
    parser.add_argument("--base_folder", type=str, required=True)
    parser.add_argument("--plates", nargs="+", required=True)
    parser.add_argument("--exp", type=str, required=True)
    parser.add_argument("--na_cutoff", type=float, default=0.5)
    parser.add_argument("--corr_3hold", type=float, default=0.9)
    parser.add_argument("--per_time", action="store_true")
    parser.add_argument("--output_bucket", type=str, required=True)
    parser.add_argument("--output_prefix", type=str, required=True)
    parser.add_argument("--local_dir", type=str, default="temp_data",
                        help="Kept for flag parity; no local staging is needed.")
    parser.add_argument("--device", type=str, default=None,
                        help="Torch device (default: CUDA; 'cpu' runs the plain forms).")
    args = parser.parse_args(argv)

    logging.basicConfig(format="%(asctime)s - %(levelname)s - %(message)s", level=logging.INFO)
    from saguaro_tpu_torch.pipeline.profile_stages import run_feature_select_cosine

    return run_feature_select_cosine(
        bucket_name=args.bucket_name,
        base_folder=args.base_folder,
        plates=args.plates,
        exp=args.exp,
        na_cutoff=args.na_cutoff,
        corr_threshold=args.corr_3hold,
        per_time=args.per_time,
        output_bucket=args.output_bucket,
        output_prefix=args.output_prefix,
        device=args.device,
    )


if __name__ == "__main__":
    main()
