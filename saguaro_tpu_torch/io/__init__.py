"""Storage, TIFF and LoadData helpers (copies of saguaro_tpu.io, free of JAX)."""

from saguaro_tpu_torch.io.storage import (
    exists,
    list_prefix,
    open_file,
    read_bytes,
    read_csv_sniffed,
    write_bytes,
    write_csv,
)
from saguaro_tpu_torch.io.tiff import imread, imwrite

__all__ = [
    "open_file",
    "read_bytes",
    "write_bytes",
    "read_csv_sniffed",
    "write_csv",
    "list_prefix",
    "exists",
    "imread",
    "imwrite",
]
