"""CLI: per-timepoint merge+normalize+select+cosine (reference
Pycyto_pertime.py:174-196 — flags preserved; port of
``saguaro_tpu/cli/pycyto_pertime.py``, plus ``--device``)."""

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Concatenate CSV files for multiple timepoints, normalize "
        "against DMSO, feature-select, and compute replicate cosine similarity."
    )
    parser.add_argument("--bucket_name", required=True, help="Bucket containing the files.")
    parser.add_argument("--base_folder", required=True,
                        help="Base folder path where experiment folders are stored.")
    parser.add_argument("--times", nargs="+", required=True,
                        help="List of times to process (prefixes from CP feature extraction).")
    parser.add_argument("--output_bucket", required=True,
                        help="Bucket where output files will be saved.")
    parser.add_argument("--output_prefix", required=True, help="Prefix for output files.")
    parser.add_argument("--local_dir", default="temp_data",
                        help="Kept for flag parity; no local staging is needed.")
    parser.add_argument("--device", type=str, default=None,
                        help="Torch device (default: CUDA; 'cpu' runs the plain forms).")
    args = parser.parse_args(argv)

    print(f"Processing Plate {args.base_folder}...")
    from saguaro_tpu_torch.pipeline.profile_stages import run_pycyto_pertime

    return run_pycyto_pertime(
        bucket_name=args.bucket_name,
        base_folder=args.base_folder,
        times=args.times,
        output_bucket=args.output_bucket,
        output_prefix=args.output_prefix,
        device=args.device,
    )


if __name__ == "__main__":
    main()
