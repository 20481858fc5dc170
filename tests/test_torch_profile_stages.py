"""The five profile CLIs of the port (normalize_cp, feature_select_cosine,
pycyto_pertime, concat_cp, induction_hit, with ``--device cpu``) against the
reference's on the same small plate (24 wells x 2 timepoints of the
feature-extraction job's layout, values from the seed): every output CSV
equals the reference's (``torch_data.assert_csv_close``: numbers to 1e-5
relative), the same plots are drawn, and the hit lists are equal."""

import importlib
import os

import pandas as pd
import pytest
import torch

from saguaro_tpu.ops import hit_calling as ref_hit_calling
from saguaro_tpu_torch.ops import hit_calling

from .torch_data import assert_csv_close, profile_cli_args, share_cpu_threads, write_cp_plate

share_cpu_threads()

PLATE, TIMES, N_WELLS = "P1", ["6", "24"], 24
META = ["Metadata_Plate", "Metadata_Well", "Metadata_Site", "Metadata_Timepoint",
        "Metadata_Compound", "Metadata_ConcLevel"]
COLUMNS = {
    "Image": ["ImageNumber", "Count_Nuclei", "Intensity_MeanIntensity_DNA",
              "Granularity_1_DNA", "Granularity_2_DNA", *META],
    **{name: ["ImageNumber", "ObjectNumber", *[f"AreaShape_F{k}" for k in range(6)],
              "Intensity_MeanIntensity_DNA", "Number_Object_Number", *parents, *META]
       for name, parents in (("Nuclei", []), ("Cells", ["Parent_Nuclei"]),
                             ("Cytoplasm", ["Parent_Cells", "Parent_Nuclei"]))},
}


def _outputs(root: str, out: str) -> list[str]:
    base = os.path.join(root, out)
    return sorted(os.path.relpath(os.path.join(d, f), base)
                  for d, _, files in os.walk(base) for f in files)


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("profile_plate"))
    write_cp_plate(root, PLATE, TIMES, N_WELLS, COLUMNS, seed=3)
    for pkg, out, extra in (("saguaro_tpu", "ref", []), ("saguaro_tpu_torch", "port", ["--device", "cpu"])):
        for name, argv in profile_cli_args(root, PLATE, TIMES, out):
            importlib.import_module(f"{pkg}.cli.{name}").main(argv + extra)
    return root


def test_every_output_matches_the_reference(chains):
    root = chains
    ref_files, port_files = _outputs(root, "ref"), _outputs(root, "port")
    assert port_files == ref_files
    csvs = [f for f in ref_files if f.endswith(".csv")]
    pngs = [f for f in ref_files if f.endswith(".png")]
    assert len(csvs) == 2 + 4 + 3 * len(TIMES) + 4 and len(pngs) >= 3
    for f in csvs:
        rows, cols = assert_csv_close(os.path.join(root, "port", f), os.path.join(root, "ref", f))
        assert rows > 0 and cols > 1, f


def test_hit_lists_match_the_reference(chains):
    root = chains
    key = "selected/Exp_CP_features_selected_allTimes_dSig.csv"
    want, _, _ = ref_hit_calling(pd.read_csv(os.path.join(root, "ref", key)))
    got, _, _ = hit_calling(pd.read_csv(os.path.join(root, "port", key)), device="cpu")
    cols = ["Metadata_Plate", "Metadata_Timepoint", "Metadata_Compound", "Metadata_ConcLevel", "Bioactive"]
    pd.testing.assert_frame_equal(got[cols], want[cols])
    hits = set(got.loc[got["Bioactive"] == 1, "Metadata_Compound"])
    shifted = {c for c in got["Metadata_Compound"] if int(c[3:]) % 5 == 0}
    assert shifted and shifted <= hits


@pytest.mark.parametrize("name", ["normalize_cp", "feature_select_cosine", "pycyto_pertime",
                                  "concat_cp", "induction_hit"])
def test_cli_without_device_raises_when_cuda_absent(monkeypatch, tmp_path, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root = str(tmp_path)
    write_cp_plate(root, PLATE, TIMES[:1], 8, COLUMNS, seed=1)
    argv = dict(profile_cli_args(root, PLATE, TIMES[:1], "out"))[name]
    with pytest.raises(RuntimeError, match="CUDA"):
        importlib.import_module(f"saguaro_tpu_torch.cli.{name}").main(argv)
