"""TIFF codec built on PIL (tifffile-free).

Port of ``saguaro_tpu.io.tiff`` without the native ``fast_tiff`` reader:
both directions go through PIL (imageio, which the reference decodes
with, is not needed). Supports uint8/uint16/float inputs.
"""

from __future__ import annotations

import io

import numpy as np

from saguaro_tpu_torch.io import storage

__all__ = ["imread", "imwrite", "decode", "encode"]


def decode(data: bytes) -> np.ndarray:
    """Decode TIFF/PNG/JPEG bytes to an array (the first page), in native
    byte order."""
    from PIL import Image

    with Image.open(io.BytesIO(data)) as pil:
        arr = np.asarray(pil)
    return arr.astype(arr.dtype.newbyteorder("="), copy=False)


def encode(image: np.ndarray, compression: str | None = None) -> bytes:
    """Encode an array as TIFF bytes; ``compression='lzw'`` writes LZW."""
    from PIL import Image

    image = np.asarray(image)
    pil = Image.fromarray(image)
    buf = io.BytesIO()
    if compression == "lzw":
        pil.save(buf, format="tiff", compression="tiff_lzw")
    else:
        pil.save(buf, format="tiff")
    return buf.getvalue()


def imread(path: str) -> np.ndarray:
    return decode(storage.read_bytes(path))


def imwrite(path: str, image: np.ndarray, compression: str | None = None) -> None:
    storage.write_bytes(path, encode(image, compression=compression))
