"""CLI surface of the port: one entry point per reference script, with the
reference CLIs' flags and one more, ``--device`` (CUDA unless given, e.g.
``--device cpu``).

  python -m saguaro_tpu_torch.cli.max_projection   <- MaxProjection.py
  python -m saguaro_tpu_torch.cli.rebin            <- Image_re-binning.py
  python -m saguaro_tpu_torch.cli.illumination_qc  <- Illumination_QC_mult.py
  python -m saguaro_tpu_torch.cli.estimate_illum   (writes <ch>_illum.npy)

Bucket arguments accept bare S3 bucket names, s3:// or gs:// URLs, or
local directories.
"""
