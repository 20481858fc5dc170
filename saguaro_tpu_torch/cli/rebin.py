"""CLI: image re-binning (reference Image_re-binning.py:67-81)."""

import argparse
import logging


def main(argv=None):
    parser = argparse.ArgumentParser(description="Process and re-bin images from a folder.")
    parser.add_argument("--bucket_name", type=str, required=True,
                        help="S3 bucket (or local dir) containing the files.")
    parser.add_argument("--image_folder", type=str, required=True,
                        help="Source folder path (e.g. 'path/to/experiment/Image/').")
    parser.add_argument("--resolution", type=int, default=1080,
                        help="Target resolution for the square image.")
    parser.add_argument("--device", type=str, default=None,
                        help="Torch device (default: CUDA; 'cpu' runs the plain forms).")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    from saguaro_tpu_torch.pipeline.pixel_stages import run_rebin

    n = run_rebin(args.bucket_name, args.image_folder, args.resolution, device=args.device)
    logging.info("Done! Processed %d images.", n)


if __name__ == "__main__":
    main()
