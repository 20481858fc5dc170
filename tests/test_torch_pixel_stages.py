"""The port's pixel-stage drivers and CLIs (``--device cpu``) against the
JAX package's on the same fake plates: the same output paths, identical
projections, re-binned TIFFs within 1 integer unit, the same QC CSV
columns and rows (slopes to 1e-4 relative, PercentMaximal and error
strings exactly) and ``<ch>_illum.npy`` within 1e-5 relative. A failure of
the batched device work raises out of the driver; a file that cannot be
read fails alone."""

import os
import shutil

import numpy as np
import pandas as pd
import pytest
import torch

from saguaro_tpu.io import tiff as ref_tiff
from saguaro_tpu_torch.io import tiff
from saguaro_tpu_torch.kernels import resample
from saguaro_tpu_torch.pipeline import pixel_stages as ps

from .fixtures import make_fake_plate

from .torch_data import share_cpu_threads

share_cpu_threads()

CHANNELS = ("DNA", "GFP")


@pytest.fixture(scope="module")
def plate(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_pixel"))
    load_data, paths = make_fake_plate(root, n_wells=3, image_size=64, channels=CHANNELS, seed=5)
    return load_data, paths


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _stack_plate(root, n_fields=2, n_ch=2, n_planes=3, size=(40, 52), seed=0):
    """Raw z-stacks under root/Images and their index CSV (plane-major
    chunks of channels x planes rows per field)."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "Images"))
    rows, planes = [], {}
    for f in range(n_fields):
        for p in range(n_planes):
            for c in range(n_ch):
                name = f"F{f}_ch{c}_p{p}.tiff"
                img = rng.integers(0, 4000, size).astype(np.uint16)
                ref_tiff.imwrite(os.path.join(root, "Images", name), img)
                planes[name] = img
                rows.append({"PlateID": "P1", "Image_PathName": "Images", "Image_FileName": name})
    pd.DataFrame(rows).to_csv(os.path.join(root, "index.csv"), index=False)
    return planes


@pytest.mark.parametrize("via_cli", [False, True], ids=["driver", "cli"])
def test_max_projection_matches_reference(tmp_path, via_cli):
    from saguaro_tpu.cli.max_projection import main as ref_main
    from saguaro_tpu.pipeline.pixel_stages import run_max_projection as ref_run
    from saguaro_tpu_torch.cli.max_projection import main

    roots = {k: str(tmp_path / k) for k in ("ref", "port")}
    planes = [_stack_plate(r) for r in roots.values()][0]
    args = ["--bucket_data_set", "{root}", "--data_set", "index.csv", "--channels", "2",
            "--planes", "3", "--bucket_images", "{root}", "--batch_size", "3"]
    if via_cli:
        ref_main([a.format(root=roots["ref"]) for a in args])
        main([a.format(root=roots["port"]) for a in args] + ["--device", "cpu"])
    else:
        assert ref_run(roots["ref"], "index.csv", 2, 3, roots["ref"], batch_size=3) == 4
        assert ps.run_max_projection(roots["port"], "index.csv", 2, 3, roots["port"], batch_size=3,
                                     device="cpu") == 4
    out = _files(os.path.join(roots["port"], "ImagesStacked"))
    assert out == _files(os.path.join(roots["ref"], "ImagesStacked"))
    assert out == ["F0_ch0_p0.tiff", "F0_ch1_p0.tiff", "F1_ch0_p0.tiff", "F1_ch1_p0.tiff"]
    for name in out:
        got = tiff.imread(os.path.join(roots["port"], "ImagesStacked", name))
        want = ref_tiff.imread(os.path.join(roots["ref"], "ImagesStacked", name))
        assert got.dtype == np.uint16 and np.array_equal(got, want)
        stem = name.rsplit("_p0", 1)[0]
        assert np.array_equal(got, np.maximum.reduce([planes[f"{stem}_p{p}.tiff"] for p in range(3)]))


def test_max_projection_isolates_unreadable_file(tmp_path):
    root = str(tmp_path)
    _stack_plate(root)
    with open(os.path.join(root, "Images", "F0_ch1_p2.tiff"), "wb") as f:
        f.write(b"not a tiff")
    assert ps.run_max_projection(root, "index.csv", 2, 3, root, device="cpu") == 3
    assert "F0_ch1_p0.tiff" not in os.listdir(os.path.join(root, "ImagesStacked"))


@pytest.mark.parametrize("via_cli", [False, True], ids=["driver", "cli"])
def test_rebin_matches_reference(plate, tmp_path, via_cli):
    from saguaro_tpu.cli.rebin import main as ref_main
    from saguaro_tpu.pipeline.pixel_stages import run_rebin as ref_run
    from saguaro_tpu_torch.cli.rebin import main

    _, paths = plate
    roots = {}
    for k in ("ref", "port"):
        roots[k] = str(tmp_path / k)
        shutil.copytree(paths["images"], os.path.join(roots[k], "Images"))
    # a float image of another shape forms its own batch
    extra = np.random.default_rng(9).normal(200, 40, (50, 70)).astype(np.float32)
    for r in roots.values():
        ref_tiff.imwrite(os.path.join(r, "Images", "extra_f32.tiff"), extra)
    if via_cli:
        ref_main(["--bucket_name", roots["ref"], "--image_folder", "Images/", "--resolution", "48"])
        main(["--bucket_name", roots["port"], "--image_folder", "Images/", "--resolution", "48",
              "--device", "cpu"])
    else:
        assert ref_run(roots["ref"], "Images", resolution=48, batch_size=4) == 7
        assert ps.run_rebin(roots["port"], "Images", resolution=48, batch_size=4, device="cpu") == 7
    # the reference's literal 'Image' -> 'Image_binned' rewrite
    binned = "Image_binneds"
    out = _files(os.path.join(roots["port"], binned))
    assert out == _files(os.path.join(roots["ref"], binned)) and len(out) == 7
    for name in out:
        got = tiff.imread(os.path.join(roots["port"], binned, name))
        want = ref_tiff.imread(os.path.join(roots["ref"], binned, name))
        assert got.shape == want.shape == (48, 48) and got.dtype == want.dtype
        if got.dtype == np.uint16:
            assert np.abs(got.astype(np.int64) - want.astype(np.int64)).max() <= 1
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


def test_rebin_failure_raises_instead_of_dropping_the_batch(plate, tmp_path, monkeypatch):
    _, paths = plate
    root = str(tmp_path)
    shutil.copytree(paths["images"], os.path.join(root, "Images"))

    def broken(*args, **kwargs):
        raise RuntimeError("resize failed")

    monkeypatch.setattr(ps, "lanczos_resize_batch", broken)
    with pytest.raises(RuntimeError, match="resize failed"):
        ps.run_rebin(root, "Images", resolution=32, device="cpu")


def _qc_frames(paths, tmp_path, illum_path, via_cli):
    from saguaro_tpu.cli.illumination_qc import main as ref_main
    from saguaro_tpu.pipeline.pixel_stages import run_illumination_qc as ref_run
    from saguaro_tpu_torch.cli.illumination_qc import main

    out = {k: str(tmp_path / f"qc_{k}.csv") for k in ("ref", "port")}
    if via_cli:
        args = ["--load-data", paths["load_data"], "--data-path", paths["images"],
                "--channels", *CHANNELS]
        if illum_path:
            args += ["--illum-path", illum_path]
        ref_main(args + ["--output", out["ref"]])
        main(args + ["--output", out["port"], "--device", "cpu"])
    else:
        ref_run(paths["load_data"], paths["images"], list(CHANNELS), out["ref"], illum_path,
                batch_size=2)
        ps.run_illumination_qc(paths["load_data"], paths["images"], list(CHANNELS), out["port"],
                               illum_path, batch_size=2, device="cpu")
    return pd.read_csv(out["ref"]), pd.read_csv(out["port"])


def _assert_qc_frames_close(ref, got):
    assert list(got.columns) == list(ref.columns)
    assert len(got) == len(ref)
    for col in ref.columns:
        if "PowerLogLogSlope" in col:
            np.testing.assert_allclose(got[col], ref[col], rtol=1e-4, atol=1e-6)
        else:
            pd.testing.assert_series_equal(got[col], ref[col])


@pytest.mark.parametrize("via_cli", [False, True], ids=["driver", "cli"])
def test_illumination_qc_matches_reference(plate, tmp_path, via_cli):
    _, paths = plate
    illum_dir = str(tmp_path / "illum")
    os.makedirs(illum_dir)
    rng = np.random.default_rng(4)
    for ch in CHANNELS:
        np.save(os.path.join(illum_dir, f"{ch}_illum.npy"),
                rng.uniform(0.7, 1.3, (64, 64)).astype(np.float32))
    ref, got = _qc_frames(paths, tmp_path, illum_dir, via_cli)
    assert (got["ImageQuality_PowerLogLogSlope_DNA"] < 0).all()
    _assert_qc_frames_close(ref, got)


def test_illumination_qc_records_missing_files(plate, tmp_path):
    load_data, paths = plate
    broken = load_data.copy()
    broken.loc[1, "FileName_GFP"] = "missing.tiff"
    bad = os.path.join(paths["images"], "garbage.tiff")
    with open(bad, "wb") as f:
        f.write(b"not a tiff")
    broken.loc[2, "FileName_DNA"] = "garbage.tiff"
    csv = str(tmp_path / "broken.csv")
    broken.to_csv(csv, index=False)
    try:
        ref, got = _qc_frames(dict(paths, load_data=csv), tmp_path, None, via_cli=False)
    finally:
        os.remove(bad)
    assert got.loc[1, "QC_Error_GFP"] == "File Not Found"
    # both record the undecodable file; the decoders' messages differ
    # (the reference decodes with imageio, the port with PIL)
    assert isinstance(got.loc[2, "QC_Error_DNA"], str)
    assert isinstance(ref.loc[2, "QC_Error_DNA"], str)
    _assert_qc_frames_close(ref.drop(columns=["QC_Error_DNA"]), got.drop(columns=["QC_Error_DNA"]))


def test_estimate_illum_cli_matches_reference(plate, tmp_path):
    from saguaro_tpu.cli.estimate_illum import main as ref_main
    from saguaro_tpu_torch.cli.estimate_illum import main

    _, paths = plate
    args = ["--load-data", paths["load_data"], "--data-path", paths["images"],
            "--channels", *CHANNELS, "--sigma", "6"]
    ref_main(args + ["--output", str(tmp_path / "ref")])
    main(args + ["--output", str(tmp_path / "port"), "--device", "cpu"])
    for ch in CHANNELS:
        got = np.load(tmp_path / "port" / f"{ch}_illum.npy")
        want = np.load(tmp_path / "ref" / f"{ch}_illum.npy")
        assert got.dtype == want.dtype == np.float32 and got.shape == (64, 64)
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_illum_functions_cross_packages(plate, tmp_path):
    """Each package's illumination functions feed the other's QC."""
    from saguaro_tpu.cli.estimate_illum import main as ref_estimate
    from saguaro_tpu.pipeline.pixel_stages import run_illumination_qc as ref_qc
    from saguaro_tpu_torch.cli.estimate_illum import main as estimate

    _, paths = plate
    args = ["--load-data", paths["load_data"], "--data-path", paths["images"],
            "--channels", *CHANNELS, "--sigma", "6"]
    ref_estimate(args + ["--output", str(tmp_path / "ref_illum")])
    estimate(args + ["--output", str(tmp_path / "port_illum"), "--device", "cpu"])
    frames = {}
    for k, (qc, illum, kw) in {
        "ref_on_port": (ref_qc, "port_illum", {}),
        "port_on_ref": (ps.run_illumination_qc, "ref_illum", {"device": "cpu"}),
    }.items():
        out = str(tmp_path / f"{k}.csv")
        qc(paths["load_data"], paths["images"], list(CHANNELS), out, str(tmp_path / illum), **kw)
        frames[k] = pd.read_csv(out)
    _assert_qc_frames_close(frames["ref_on_port"], frames["port_on_ref"])


def test_drivers_move_batches_to_the_device(plate, tmp_path, monkeypatch):
    """The re-binning driver hands the resize a tensor on its device."""
    _, paths = plate
    root = str(tmp_path)
    shutil.copytree(paths["images"], os.path.join(root, "Images"))
    seen = []

    def spy(batch, out_shape):
        seen.append((type(batch), batch.device, tuple(batch.shape)))
        return resample.lanczos_resize_batch(batch, out_shape)

    monkeypatch.setattr(ps, "lanczos_resize_batch", spy)
    assert ps.run_rebin(root, "Images", resolution=32, batch_size=4, device="cpu") == 6
    assert seen == [(torch.Tensor, torch.device("cpu"), (4, 64, 64)),
                    (torch.Tensor, torch.device("cpu"), (2, 64, 64))]
