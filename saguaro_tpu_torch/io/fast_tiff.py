"""ctypes bridge to the native TIFF decoder (``native/tiff_reader.cc``; port of
``saguaro_tpu/io/fast_tiff.py``).

ctypes releases the GIL around the decode, so host reader threads (the
prefetch pool of ``pipeline/segment_embed``) decode in parallel. Which
codec reads a file is decided by the file's own TIFF fields:
``sgtiff_probe`` accepts little-endian, one sample of 8 or 16 unsigned
bits, black-is-zero, in strips, uncompressed or LZW with predictor 1 or 2,
and ``decode`` returns None for everything else, which ``io.tiff`` hands to
PIL. Unlike the reference, nothing falls back quietly: a file the probe
accepts and the decoder rejects raises ``ValueError`` with the reader's
code, and a failed build raises.

The library is compiled at first use with
``g++ -O3 -shared -fPIC -std=c++17`` into ``_build/libsgtiff_<hash>.so``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

__all__ = ["decode", "probe", "build", "DECODE_ERRORS"]

_PKG = Path(__file__).resolve().parents[1]
_SRC = _PKG / "native" / "tiff_reader.cc"
_BUILD = _PKG / "_build"
_CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

# sgtiff_decode's negative codes
DECODE_ERRORS = {
    -1: "not a little-endian TIFF",
    -2: "no image size",
    -3: "more than one sample a pixel",
    -4: "bits a sample other than 8 or 16",
    -5: "compression other than none or LZW",
    -6: "output buffer too small",
    -7: "fewer strip offsets or byte counts than strips",
    -8: "a strip lies beyond the end of the file",
    -9: "an uncompressed strip is shorter than its rows",
    -10: "an LZW strip is corrupt or short",
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def build() -> Path:
    """Compile ``native/tiff_reader.cc`` unless a library built from the same
    source and flags is already in ``_build/``; raises ``RuntimeError`` with
    the compiler's output when the build fails."""
    digest = hashlib.sha256(" ".join(_CXX_FLAGS).encode() + _SRC.read_bytes()).hexdigest()[:16]
    lib = _BUILD / f"libsgtiff_{digest}.so"
    if lib.exists():
        return lib
    _BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=_BUILD, suffix=".so")
    os.close(fd)
    try:
        res = subprocess.run(["g++", *_CXX_FLAGS, str(_SRC), "-o", tmp],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"building the native TIFF decoder failed "
                               f"({res.returncode}):\n{res.stderr[-4000:]}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, n, ip = ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_int)
            lib.sgtiff_probe.argtypes = [p, n, ip, ip, ip]
            lib.sgtiff_probe.restype = ctypes.c_int
            lib.sgtiff_decode.argtypes = [p, n, ctypes.c_void_p, n]
            lib.sgtiff_decode.restype = ctypes.c_int
            _lib = lib
        return _lib


def probe(data: bytes) -> tuple[int, int, np.dtype] | None:
    """(height, width, dtype) when the native decoder covers the file's TIFF
    fields, else None."""
    h, w, bits = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if _load().sgtiff_probe(data, len(data), ctypes.byref(h), ctypes.byref(w),
                            ctypes.byref(bits)) != 0:
        return None
    return h.value, w.value, np.dtype(np.uint16 if bits.value == 16 else np.uint8)


def decode(data: bytes) -> np.ndarray | None:
    """Decode TIFF bytes natively, or None when the file's fields ask for
    another codec; raises ``ValueError`` on a file the probe accepts and the
    decoder rejects (a truncated or corrupt strip)."""
    shape = probe(data)
    if shape is None:
        return None
    h, w, dtype = shape
    out = np.empty((h, w), dtype)
    rc = _load().sgtiff_decode(data, len(data), out.ctypes.data_as(ctypes.c_void_p), out.nbytes)
    if rc != 0:
        raise ValueError(f"corrupt TIFF: the native decoder returned {rc} "
                         f"({DECODE_ERRORS.get(rc, 'unknown error')})")
    return out
