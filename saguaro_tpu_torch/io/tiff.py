"""TIFF codec (tifffile-free; port of ``saguaro_tpu.io.tiff``).

TIFFs that the native decoder covers (``io/fast_tiff``: little-endian 8/16
bits, one sample, strips, none or LZW) decode off the GIL; every other
file, and encoding, goes through PIL (imageio, the reference's other
codec, is not needed). Supports uint8/uint16/float inputs.
"""

from __future__ import annotations

import io

import numpy as np

from saguaro_tpu_torch.io import storage

__all__ = ["imread", "imwrite", "decode", "encode"]


def decode(data: bytes) -> np.ndarray:
    """Decode TIFF/PNG/JPEG bytes to an array (the first page), in native
    byte order. A TIFF that the native decoder covers but cannot decode
    raises ``ValueError``."""
    if data[:4] in (b"II*\x00", b"MM\x00*"):
        from saguaro_tpu_torch.io import fast_tiff

        out = fast_tiff.decode(data)
        if out is not None:
            return out
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
