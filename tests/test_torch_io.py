"""The port's copies of the JAX-free helpers behave as the reference's:
storage, TIFF codec, LoadData helpers, bucket paths, Zernike tables."""

import os

import numpy as np
import pandas as pd
import pytest

from saguaro_tpu.io import loaddata as ref_loaddata
from saguaro_tpu.io import storage as ref_storage
from saguaro_tpu.io import tiff as ref_tiff
from saguaro_tpu.kernels import zernike as ref_zernike
from saguaro_tpu.pipeline.pixel_stages import bucket_path as ref_bucket_path
from saguaro_tpu_torch.io import loaddata, storage, tiff
from saguaro_tpu_torch.kernels import zernike
from saguaro_tpu_torch.pipeline.pixel_stages import bucket_path


def test_csv_roundtrip_and_sniffing(tmp_path):
    df = pd.DataFrame({"a": [1, 2], "b": ["x", "y"]})
    p = str(tmp_path / "sub" / "t.csv")
    storage.write_csv(df, p)
    pd.testing.assert_frame_equal(storage.read_csv_sniffed(p), ref_storage.read_csv_sniffed(p))
    semi = str(tmp_path / "semi.csv")
    storage.write_bytes(semi, b"a;b\n1;x\n2;y\n")
    pd.testing.assert_frame_equal(storage.read_csv_sniffed(semi), df)
    assert storage.exists(semi) and storage.join("s3://b", "k", "f") == ref_storage.join("s3://b", "k", "f")


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
def test_tiff_roundtrip(tmp_path, dtype):
    img = (np.random.default_rng(0).random((17, 23)) * 200).astype(dtype)
    p = str(tmp_path / "a.tiff")
    tiff.imwrite(p, img, compression="lzw" if dtype != np.float32 else None)
    np.testing.assert_array_equal(tiff.imread(p), img)
    np.testing.assert_array_equal(ref_tiff.imread(p), img)
    with pytest.raises(Exception):
        tiff.decode(b"not a tiff at all")


def test_loaddata_helpers(tmp_path):
    np.save(os.path.join(tmp_path, "DNA_illum.npy"), np.full((4, 4), 2.0, np.float32))
    np.save(os.path.join(tmp_path, "IllumGFP.npy"), np.ones((4, 4), np.float32))
    got = loaddata.load_illum_functions(str(tmp_path), ["DNA", "GFP", "ER"])
    want = ref_loaddata.load_illum_functions(str(tmp_path), ["DNA", "GFP", "ER"])
    assert got[2] is None and want[2] is None
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g, w)
    row = pd.Series({"FileName_DNA": "a.tif", "FileName_GFP": "b.tif"})
    assert loaddata.site_image_paths(row, ["DNA", "GFP"], "/x") == ref_loaddata.site_image_paths(
        row, ["DNA", "GFP"], "/x"
    )
    for pos in (1, 24, 25, 384):
        assert loaddata.position_to_well(pos) == ref_loaddata.position_to_well(pos)


@pytest.mark.parametrize("bucket,key", [("/data", "a/b"), ("./rel", "k"), ("s3://b", "k"), ("bucket", "k"), ("b", "")])
def test_bucket_path(bucket, key):
    assert bucket_path(bucket, key) == ref_bucket_path(bucket, key)


def test_zernike_tables_equal():
    assert zernike.ZERNIKE_INDEXES == ref_zernike.ZERNIKE_INDEXES
    np.testing.assert_array_equal(zernike._radial_coeffs(), ref_zernike._radial_coeffs())
