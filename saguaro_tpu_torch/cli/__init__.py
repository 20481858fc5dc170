"""CLI surface of the port: one entry point per reference script, with the
reference CLIs' flags and one more, ``--device`` (CUDA unless given, e.g.
``--device cpu``).

  python -m saguaro_tpu_torch.cli.max_projection   <- MaxProjection.py
  python -m saguaro_tpu_torch.cli.rebin            <- Image_re-binning.py
  python -m saguaro_tpu_torch.cli.illumination_qc  <- Illumination_QC_mult.py
  python -m saguaro_tpu_torch.cli.estimate_illum   (writes <ch>_illum.npy)
  python -m saguaro_tpu_torch.cli.segment_embed    <- Cellpose_GPU_s3fs.py
  python -m saguaro_tpu_torch.cli.feature_extraction   <- Feature_extraction_opt.py
  python -m saguaro_tpu_torch.cli.normalize_cp         <- Normalize_CP_ami.py
  python -m saguaro_tpu_torch.cli.pycyto_pertime       <- Pycyto_pertime.py
  python -m saguaro_tpu_torch.cli.feature_select_cosine <- Feature_select_cosine_ami.py
  python -m saguaro_tpu_torch.cli.induction_hit        <- Inuction_Score_hit.py
  python -m saguaro_tpu_torch.cli.concat_cp            <- ConcatCP_exp.py

Bucket arguments accept bare S3 bucket names, s3:// or gs:// URLs, or
local directories.
"""
