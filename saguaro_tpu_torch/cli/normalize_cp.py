"""CLI: per-plate/timepoint normalization (reference
Normalize_CP_ami.py:153-181 — flags preserved; port of
``saguaro_tpu/cli/normalize_cp.py``, plus ``--device``)."""

import argparse
import logging


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Normalize each timepoint of a project folder; outputs "
        "normalized tables against DMSO."
    )
    parser.add_argument("--bucket_name", type=str, required=True,
                        help="S3 bucket (or local dir) containing the files.")
    parser.add_argument("--base_folder", type=str, required=True,
                        help="Base folder path where experiment folders are stored.")
    parser.add_argument("--plates", nargs="+", required=True,
                        help="List of plates to process (prefix Plate/Time/csv).")
    parser.add_argument("--times", nargs="+", help="List of times to process.")
    parser.add_argument("--DMSO", type=str, default="DMSO",
                        help="DMSO nomenclature used to normalize in the plateMap.")
    parser.add_argument("--output_bucket", type=str, required=True,
                        help="Bucket where output files will be saved.")
    parser.add_argument("--output_prefix", type=str, required=True,
                        help="Prefix for the output files.")
    parser.add_argument("--well_agg_func", type=str, default="mean",
                        help="Function to aggregate at well level. Default mean.")
    parser.add_argument("--no_time_subFolder", action="store_true")
    parser.add_argument("--qc_drop", action="store_true")
    parser.add_argument("--device", type=str, default=None,
                        help="Torch device (default: CUDA; 'cpu' runs the plain forms).")
    args = parser.parse_args(argv)

    logging.basicConfig(format="%(asctime)s - %(levelname)s - %(message)s", level=logging.INFO)
    from saguaro_tpu_torch.pipeline.profile_stages import run_normalize_cp

    return run_normalize_cp(
        bucket_name=args.bucket_name,
        base_folder=args.base_folder,
        plates=args.plates,
        times=args.times,
        output_bucket=args.output_bucket,
        output_prefix=args.output_prefix,
        dmso=args.DMSO,
        well_agg_func=args.well_agg_func,
        no_time_subfolder=args.no_time_subFolder,
        qc_drop=args.qc_drop,
        device=args.device,
    )


if __name__ == "__main__":
    main()
