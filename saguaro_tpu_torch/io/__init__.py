"""Storage, TIFF and LoadData helpers (copies of saguaro_tpu.io, free of JAX)."""
