"""CLI: z-stack max projection (reference MaxProjection.py:54-62)."""

import argparse
import logging


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Max-project plate z-stacks and upload results."
    )
    parser.add_argument("--bucket_data_set", type=str, required=True,
                        help="S3 bucket (or local dir) containing the data set.")
    parser.add_argument("--data_set", type=str, required=True,
                        help="Data set key with ChannelName/ChannelID/Image_FileName/"
                             "Image_PathName/FieldID/PlaneID/PlateID/Row/Col/Timestamp columns.")
    parser.add_argument("--channels", type=int, required=True, help="Number of channels per group")
    parser.add_argument("--planes", type=int, required=True, help="Number of planes per channel")
    parser.add_argument("--bucket_images", type=str, required=True,
                        help="S3 bucket (or local dir) containing the raw images.")
    parser.add_argument("--batch_size", type=int, default=16, help="Device batch of stacks.")
    parser.add_argument("--device", type=str, default=None,
                        help="Torch device (default: CUDA; 'cpu' runs the plain forms).")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    from saguaro_tpu_torch.pipeline.pixel_stages import run_max_projection

    n = run_max_projection(
        args.bucket_data_set, args.data_set, args.channels, args.planes,
        args.bucket_images, args.batch_size, device=args.device,
    )
    logging.info("Wrote %d projections.", n)


if __name__ == "__main__":
    main()
