"""CLI: image QC (reference Illumination_QC_mult.py:17-25)."""

import argparse
import logging


def main(argv=None):
    parser = argparse.ArgumentParser(description="CellProfiler-Matched Image QC")
    parser.add_argument("--load-data", type=str, required=True,
                        help="Path to input CSV (LoadData format)")
    parser.add_argument("--data-path", type=str, required=True, help="Base path for image files")
    parser.add_argument("--illum-path", type=str, default=None,
                        help="Folder containing .npy illumination functions")
    parser.add_argument("--channels", nargs="+", required=True,
                        help="List of channel names (e.g. CL488 CL568)")
    parser.add_argument("--output", type=str, default="QC_Results.csv", help="Path for output CSV")
    parser.add_argument("--threads", type=int, default=24,
                        help="Kept for flag parity; QC is device-batched, not threaded.")
    parser.add_argument("--device", type=str, default=None,
                        help="Torch device (default: CUDA; 'cpu' runs the plain forms).")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    from saguaro_tpu_torch.pipeline.pixel_stages import run_illumination_qc

    run_illumination_qc(
        args.load_data, args.data_path, args.channels, args.output, args.illum_path,
        device=args.device,
    )
    logging.info("Done! Saved to %s", args.output)


if __name__ == "__main__":
    main()
