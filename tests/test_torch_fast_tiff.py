"""The port's native TIFF decoder (``saguaro_tpu_torch.io.fast_tiff``) against
PIL and against the reference's ``fast_tiff.decode``, bit-equal, on the
layouts it covers (uint8/uint16, uncompressed and LZW, predictor 1 and 2,
one strip and several); the files it does not cover (big-endian, tiled,
deflate) go to PIL through ``io.tiff.decode``; a corrupt file and a failed
build raise."""

import io
import struct
import threading

import numpy as np
import pytest
from PIL import Image

from saguaro_tpu.io import fast_tiff as ref_fast_tiff
from saguaro_tpu_torch.io import fast_tiff, tiff

from .torch_data import share_cpu_threads

share_cpu_threads()


def _field(dtype, shape=(53, 77), seed=0) -> np.ndarray:
    """Smooth structure (long LZW runs) plus noise (short codes)."""
    rng = np.random.default_rng(seed)
    hi = np.iinfo(dtype).max
    yy, xx = np.mgrid[: shape[0], : shape[1]]
    smooth = (np.sin(yy / 7.0) + np.cos(xx / 5.0) + 2.0) / 4.0 * hi * 0.8
    noise = rng.integers(0, hi // 8, shape)
    return np.clip(smooth + noise, 0, hi).astype(dtype)


def _pil_save(arr: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="tiff", **kw)
    return buf.getvalue()


def _pil_decode(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        arr = np.asarray(im)
    return arr.astype(arr.dtype.newbyteorder("="))


def _tiled_tiff(arr: np.ndarray, tile: int = 16) -> bytes:
    """An uncompressed little-endian tiled TIFF of one uint16 plane (PIL
    writes no tiles)."""
    h, w = arr.shape
    ty, tx = -(-h // tile), -(-w // tile)
    padded = np.zeros((ty * tile, tx * tile), "<u2")
    padded[:h, :w] = arr
    tiles = [padded[i * tile:(i + 1) * tile, j * tile:(j + 1) * tile].tobytes()
             for i in range(ty) for j in range(tx)]
    n_tags = 10
    ifd_size = 2 + 12 * n_tags + 4
    arrays_at = 8 + ifd_size
    offsets_at, counts_at = arrays_at, arrays_at + 4 * len(tiles)
    data_at = counts_at + 4 * len(tiles)
    offs = [data_at + k * len(tiles[0]) for k in range(len(tiles))]
    tags = [(256, 3, 1, w), (257, 3, 1, h), (258, 3, 1, 16), (259, 3, 1, 1), (262, 3, 1, 1),
            (277, 3, 1, 1), (322, 3, 1, tile), (323, 3, 1, tile),
            (324, 4, len(tiles), offsets_at), (325, 4, len(tiles), counts_at)]
    out = b"II*\x00" + struct.pack("<I", 8) + struct.pack("<H", n_tags)
    for tag, typ, count, value in tags:
        packed = struct.pack("<HI", value, 0)[:4] if typ == 3 else struct.pack("<I", value)
        out += struct.pack("<HHI", tag, typ, count) + packed
    out += struct.pack("<I", 0)
    out += struct.pack(f"<{len(tiles)}I", *offs) + struct.pack(f"<{len(tiles)}I", *[len(t) for t in tiles])
    return out + b"".join(tiles)


COVERED = [
    pytest.param(dtype, kw, id=f"{np.dtype(dtype).name}-{name}")
    for dtype in (np.uint8, np.uint16)
    for name, kw in (
        ("raw", {}),
        ("raw-strips", {"tiffinfo": {278: 7}}),
        ("lzw", {"compression": "tiff_lzw"}),
        ("lzw-pred2", {"compression": "tiff_lzw", "tiffinfo": {317: 2}}),
        ("lzw-pred2-strips", {"compression": "tiff_lzw", "tiffinfo": {317: 2, 278: 5}}),
    )
]


@pytest.mark.parametrize("dtype,kw", COVERED)
def test_native_equals_pil_and_reference(dtype, kw):
    arr = _field(dtype)
    data = _pil_save(arr, **kw)
    assert fast_tiff.probe(data) == (arr.shape[0], arr.shape[1], np.dtype(dtype))
    got = fast_tiff.decode(data)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got, arr)
    np.testing.assert_array_equal(got, _pil_decode(data))
    np.testing.assert_array_equal(got, ref_fast_tiff.decode(data))
    np.testing.assert_array_equal(tiff.decode(data), arr)


@pytest.mark.parametrize("layout", ["big-endian", "tiled", "deflate", "float32"])
def test_uncovered_layouts_go_to_pil(layout):
    arr = _field(np.uint16, seed=1)
    if layout == "big-endian":
        data = _pil_save(arr.astype(">u2"))
    elif layout == "tiled":
        data = _tiled_tiff(arr)
    elif layout == "deflate":
        data = _pil_save(arr, compression="tiff_adobe_deflate")
    else:
        arr = arr.astype(np.float32) / 7.0
        data = _pil_save(arr)
    assert fast_tiff.probe(data) is None and fast_tiff.decode(data) is None
    got = tiff.decode(data)
    np.testing.assert_array_equal(got, _pil_decode(data))
    np.testing.assert_array_equal(got, arr)


@pytest.mark.parametrize("case,code", [("truncated", -8), ("lzw-corrupt", -10), ("strip-short", -9)])
def test_corrupt_file_raises_with_the_readers_code(case, code):
    arr = _field(np.uint16, seed=2)
    if case == "truncated":
        data = _pil_save(arr)[:-100]
    elif case == "strip-short":
        # the strip's byte count cut below its rows' bytes
        data = bytearray(_pil_save(arr))
        with Image.open(io.BytesIO(bytes(data))) as im:
            count = im.tag_v2[279][0]
        ifd = struct.unpack("<I", data[4:8])[0]
        for k in range(struct.unpack("<H", data[ifd:ifd + 2])[0]):
            at = ifd + 2 + 12 * k
            if struct.unpack("<H", data[at:at + 2])[0] == 279:
                data[at + 8:at + 12] = struct.pack("<I", count - 10)
        data = bytes(data)
    else:
        data = bytearray(_pil_save(arr, compression="tiff_lzw"))
        with Image.open(io.BytesIO(bytes(data))) as im:
            off = im.tag_v2[273][0]
        data[off + 40:off + 400] = b"\xff" * 360
        data = bytes(data)
    assert fast_tiff.probe(data) is not None
    with pytest.raises(ValueError, match=f"returned {code} "):
        fast_tiff.decode(data)
    with pytest.raises(ValueError, match="corrupt TIFF"):
        tiff.decode(data)


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "tiff_reader.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(fast_tiff, "_SRC", bad)
    monkeypatch.setattr(fast_tiff, "_BUILD", tmp_path / "_build")
    monkeypatch.setattr(fast_tiff, "_lib", None)
    with pytest.raises(RuntimeError, match="building the native TIFF decoder failed"):
        fast_tiff.decode(_pil_save(_field(np.uint8)))
    assert not list((tmp_path / "_build").glob("*.so"))


def test_threads_decode_in_parallel_and_agree():
    """More threads than cores decoding LZW files at once (the prefetch
    pool's use) each get their own file back."""
    fields = [_field(np.uint16, shape=(96, 128), seed=s) for s in range(6)]
    files = [_pil_save(f, compression="tiff_lzw", tiffinfo={317: 2}) for f in fields]
    errors, results = [], {}

    def work(k):
        try:
            for _ in range(5):
                results[k] = fast_tiff.decode(files[k % len(files)])
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(k,)) for k in range(24)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and not errors
    for k, got in results.items():
        np.testing.assert_array_equal(got, fields[k % len(fields)])
