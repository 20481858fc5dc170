"""CLI: compute per-channel illumination functions from a plate's images.

The reference scripts consume ``<channel>_illum.npy`` files produced by
CellProfiler's CorrectIlluminationCalculate. This computes them with the
standard recipe (mean across the plate's images per channel, large
Gaussian smooth, unit-mean normalisation; kernels/illum.estimate_illumination)
and writes the ``<channel>_illum.npy`` naming the suite expects.
"""

import argparse
import io
import logging


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Estimate per-channel illumination functions from a LoadData CSV."
    )
    parser.add_argument("--load-data", required=True, help="LoadData CSV (FileName_<ch> columns).")
    parser.add_argument("--data-path", required=True, help="Base path for image files.")
    parser.add_argument("--channels", nargs="+", required=True, help="Channel names.")
    parser.add_argument("--output", required=True, help="Directory for <ch>_illum.npy files.")
    parser.add_argument("--sigma", type=int, default=50, help="Gaussian smoothing sigma (px).")
    parser.add_argument("--max_images", type=int, default=200,
                        help="Cap on images averaged per channel.")
    parser.add_argument("--device", type=str, default=None,
                        help="Torch device (default: CUDA; 'cpu' runs the plain forms).")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    import numpy as np

    from saguaro_tpu_torch.device import resolve_device
    from saguaro_tpu_torch.io import storage, tiff
    from saguaro_tpu_torch.kernels.illum import estimate_illumination
    from saguaro_tpu_torch.pipeline.pixel_stages import bucket_path

    device = resolve_device(args.device)
    df = storage.read_csv_sniffed(args.load_data)
    for ch in args.channels:
        col = f"FileName_{ch}"
        if col not in df.columns:
            logging.warning("no %s column; skipping channel %s", col, ch)
            continue
        names = df[col].astype(str).tolist()[: args.max_images]
        imgs = []
        for name in names:
            try:
                imgs.append(tiff.imread(bucket_path(args.data_path, name)).astype(np.float32))
            except Exception as e:
                logging.error("failed to read %s: %s", name, e)
        if not imgs:
            logging.warning("no readable images for channel %s", ch)
            continue
        shape = imgs[0].shape
        imgs = [im for im in imgs if im.shape == shape]
        illum = estimate_illumination(np.stack(imgs), sigma=args.sigma, device=device)
        out_path = storage.join(args.output, f"{ch}_illum.npy")
        buf = io.BytesIO()
        np.save(buf, illum)
        storage.write_bytes(out_path, buf.getvalue())
        logging.info("wrote %s (from %d images)", out_path, len(imgs))


if __name__ == "__main__":
    main()
