"""CLI: legacy CP-table concatenator (reference ConcatCP_exp.py:99-119;
port of ``saguaro_tpu/cli/concat_cp.py``, plus ``--device``)."""

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Concatenate CP CSV files across timepoints."
    )
    parser.add_argument("--bucket_name", required=True, help="Bucket containing the files.")
    parser.add_argument("--base_folder", required=True,
                        help="Base folder path where experiment folders are stored.")
    parser.add_argument("--output_bucket", required=True,
                        help="Bucket where output files will be saved.")
    parser.add_argument("--output_prefix", required=True, help="Prefix for output files.")
    parser.add_argument("--times", nargs="+", default=None,
                        help="Timepoint folder names (defaults to the reference's list).")
    parser.add_argument("--local_dir", default="temp_data",
                        help="Kept for flag parity; no local staging is needed.")
    parser.add_argument("--device", type=str, default=None,
                        help="Torch device (default: CUDA; 'cpu' runs the plain forms).")
    args = parser.parse_args(argv)

    print(f"Processing Plate {args.base_folder}...")
    from saguaro_tpu_torch.pipeline.profile_stages import run_concat_cp

    return run_concat_cp(
        bucket_name=args.bucket_name,
        base_folder=args.base_folder,
        output_bucket=args.output_bucket,
        output_prefix=args.output_prefix,
        times=args.times,
        device=args.device,
    )


if __name__ == "__main__":
    main()
