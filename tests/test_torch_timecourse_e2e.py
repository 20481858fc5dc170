"""The reference's end-to-end screen (``tests/test_timecourse_e2e.py``) run
through the stage drivers of both packages: feature extraction over the
(plate x time) job grid -> normalize -> cross-plate select + cosine ->
induction hit calling. Four chains run on one screen: ``ref`` (the JAX
package), ``port`` (``device="cpu"``), ``cross`` (the port's profile stages
on the reference's grid CSVs) and ``reverse`` (the reference's profile
stages on the port's grid CSVs), so that a divergence is placed in the grid
or in the profile tail.

Held, with the existing tolerances:

* grid, port against reference: the same files; each job's
  Image/Nuclei/Cells/Cytoplasm tables have the same columns in the same
  order and the same rows, every value within
  ``torch_data.feature_tolerance`` (``assert_tables_close``'s rule, with
  the grid test's ``hu_floor=1e-10``: the fixture's cells are disks, whose
  third-order Hu moments are rounding noise on both sides), but for the
  cells pinned in ``PINNED_GRID``, each named with its row count and bound;
* the profile tail on either grid (``cross`` against ``ref``, ``port``
  against ``reverse``): every normalized, selected, dSig and cosine CSV
  within ``torch_data.assert_csv_close`` (numbers to 1e-5 relative), the
  same feature columns in the same order, the Bioactivities CSV within it
  too and the hit table's plate, timepoint, compound, concentration and
  ``Bioactive`` columns equal (``assert_frame_equal``). The kept columns
  are the reference's but for a pair of columns equal value for value, of
  which the reference keeps the member its f32 row sums favour; such a
  swap is pinned: the other member, its values the reference's;
* end to end, port against reference: the same normalized files, columns
  and rows, and the same hit list. The normalized values themselves are
  not held there: with two DMSO wells a plate and time, the MAD of many
  columns is one f32 rounding of the grid's, and the robust z-scores
  carry grid differences of 1e-7 relative to whole units.

The screen is the reference test's: plates 1 and 2 at timepoints 6 and
24, channels DNA and GFP, 8 wells a job of 96² images from
``make_fake_plate``; each job's seed is ``zlib.crc32("<plate>_<time>")``
(the reference test's ``hash((plate, t))`` changes with every process)."""

import os
import zlib

import numpy as np
import pandas as pd
import pytest

from saguaro_tpu.pipeline import feature_extraction as ref_fe
from saguaro_tpu.pipeline import hits as ref_hits
from saguaro_tpu.pipeline import profile_stages as ref_ps
from saguaro_tpu.pipeline.features import FeatureConfig as RefFeatureConfig
from saguaro_tpu_torch.pipeline import feature_extraction as port_fe
from saguaro_tpu_torch.pipeline import hits as port_hits
from saguaro_tpu_torch.pipeline import profile_stages as port_ps
from saguaro_tpu_torch.pipeline.features import FeatureConfig

from .fixtures import make_fake_plate
from .torch_data import assert_csv_close, feature_tolerance, share_cpu_threads

share_cpu_threads()

PLATES = ["1", "2"]
TIMES = ["6", "24"]
CHANNELS = ("DNA", "GFP")
SIZE = 96
CFG = dict(channels=CHANNELS, max_cells=16, glcm_levels=8, measure_texture=True,
           measure_zernike=True)
HIT_COLS = ["Metadata_Plate", "Metadata_Timepoint", "Metadata_Compound", "Metadata_ConcLevel",
            "Bioactive"]
DSIG = "E2E_CP_features_selected_allTimes_dSig.csv"
JOBS = [(p, t) for p in PLATES for t in TIMES]

# Grid cells beyond feature_tolerance: (plate, time, table, column) -> rows.
# Texture Correlation of Cells whose GLCM sits almost all in one cell (a
# uniform disk): E[ij] - mux * muy cancels, and the reference's own f32
# value is up to 1.3 tolerances from the exact one; both sides within
# 2.7e-5 of each other. Granularity at scales 14 to 16 of three sites: one
# side holds 4.3e-6 to 4.7e-6, the other 0, a residue of one f32 rounding of
# the background upsample (the two packages' matmuls round it apart).
PINNED_GRID = {
    **{("1", "6", "Cells", f"Texture_Correlation_{c}"): n
       for c, n in (("DNA_3_02_8", 3), ("GFP_3_00_8", 1))},
    **{("1", "24", "Cells", f"Texture_Correlation_{c}"): n
       for c, n in (("DNA_3_01_8", 2), ("DNA_3_02_8", 1), ("DNA_3_03_8", 1), ("GFP_3_01_8", 2),
                    ("GFP_3_03_8", 1))},
    **{("2", "6", "Cells", f"Texture_Correlation_{c}"): n
       for c, n in (("DNA_3_00_8", 2), ("DNA_3_01_8", 1), ("DNA_3_02_8", 2), ("DNA_3_03_8", 2),
                    ("GFP_3_02_8", 2), ("GFP_3_03_8", 2))},
    ("1", "24", "Image", "Granularity_14_DNA"): 1,
    ("1", "24", "Image", "Granularity_16_GFP"): 1,
    ("2", "24", "Image", "Granularity_15_GFP"): 1,
}
PINNED_BOUND = {"Texture_Correlation": 2.7e-5, "Granularity": 5e-6}


class GTSegmenter:
    """Replays a job's ground-truth masks in LoadData row order (the
    reference test's segmenter)."""

    def __init__(self, gt_by_job):
        self.gt_by_job = gt_by_job
        self.queue = []

    def load_job(self, plate, t):
        load_data, paths = self.gt_by_job[(plate, t)]
        self.queue = [paths["gt_masks"][(row["Metadata_Well"], row["Metadata_Site"])]
                      for _, row in load_data.iterrows()]

    def __call__(self, image):
        return self.queue.pop(0)


def _files(root: str, sub: str) -> list[str]:
    base = os.path.join(root, sub)
    return sorted(os.path.relpath(os.path.join(d, f), base)
                  for d, _, files in os.walk(base) for f in files)


def _chain(root, gt_by_job, name, grid, ps, hits, fcfg=None, cp=None, **device):
    """One chain's outputs under ``root/<name>_*``: the job grid into
    ``<name>_cp`` (or, without ``fcfg``, the CSVs already in ``cp``), the
    platemaps beside them, normalize, select + cosine and hit calling,
    each through its stage driver."""
    out = {}
    if fcfg is not None:
        cp = f"{name}_cp"
        seg = GTSegmenter(gt_by_job)

        def load_data_key_for_job(p, t):
            seg.load_job(p, t)
            return f"load_data_{p}_{t}.csv"

        out["grid"] = grid(
            bucket_name=root, base_output_path=os.path.join(root, cp), plates=PLATES,
            times=TIMES, channels=list(CHANNELS),
            image_path_for_job=lambda p, t: f"images/{p}/{t}/Images",
            load_data_key_for_job=load_data_key_for_job, segmenter=seg, feature_cfg=fcfg,
            **device)
        for plate in PLATES:
            pm = pd.read_csv(os.path.join(root, f"Plate_{plate}_PlateMap.csv"))
            pm.to_csv(os.path.join(root, cp, f"Plate_{plate}_PlateMap.csv"), index=False)
    out["normalized"] = ps.run_normalize_cp(
        bucket_name=root, base_folder=cp, plates=PLATES, times=TIMES, output_bucket=root,
        output_prefix=f"{name}_normalized", **device)
    out["selected"] = ps.run_feature_select_cosine(
        bucket_name=root, base_folder=f"{name}_normalized", plates=PLATES, exp="E2E",
        output_bucket=root, output_prefix=f"{name}_selected", na_cutoff=0.5,
        corr_threshold=0.95, **device)
    out["hits"] = hits.run_induction_hit(
        bucket_name=root, features_key=f"{name}_selected/{DSIG}", output_prefix=f"{name}_hits",
        **device)
    return out


@pytest.fixture(scope="module")
def screen(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("screen"))
    gt_by_job = {}
    for plate, t in JOBS:
        load_data, paths = make_fake_plate(
            os.path.join(root, "images", plate, t), n_wells=8, image_size=SIZE,
            channels=CHANNELS, timepoint=t, plate=plate,
            seed=zlib.crc32(f"{plate}_{t}".encode()))
        load_data.to_csv(os.path.join(root, f"load_data_{plate}_{t}.csv"), index=False)
        gt_by_job[(plate, t)] = (load_data, paths)
        if t == TIMES[0]:
            pm = pd.read_csv(paths["platemap"])
            pm["Metadata_Plate"] = plate
            pm.to_csv(os.path.join(root, f"Plate_{plate}_PlateMap.csv"), index=False)
    cpu = dict(device="cpu")
    chains = {
        "ref": _chain(root, gt_by_job, "ref", ref_fe.run_batch_processing, ref_ps, ref_hits,
                      RefFeatureConfig(**CFG)),
        "port": _chain(root, gt_by_job, "port", port_fe.run_batch_processing, port_ps,
                       port_hits, FeatureConfig(**CFG), **cpu),
    }
    chains["cross"] = _chain(root, gt_by_job, "cross", None, port_ps, port_hits, cp="ref_cp",
                             **cpu)
    chains["reverse"] = _chain(root, gt_by_job, "reverse", None, ref_ps, ref_hits, cp="port_cp")
    return root, chains


# each profile-tail hold: (chain held, chain it is held against)
TAILS = {"cross": ("cross", "ref"), "reverse": ("port", "reverse")}


def _normalized(paths) -> pd.DataFrame:
    return pd.concat([pd.read_csv(p) for p in paths], ignore_index=True)


def _kept(path) -> list[str]:
    return [c for c in pd.read_csv(path, nrows=0).columns if "Metadata" not in c]


def _twins(got_kept, want_kept, normalized: pd.DataFrame) -> dict[str, str]:
    """The kept names that differ, each mapped to the name the other chain
    kept in its place: the one other column whose normalized values equal
    its own, value for value."""
    only_got = [c for c in got_kept if c not in want_kept]
    only_want = [c for c in want_kept if c not in got_kept]
    assert len(only_got) == len(only_want), (only_got, only_want)
    twins = {}
    for g in only_got:
        equal = [w for w in only_want
                 if np.array_equal(normalized[g].to_numpy(), normalized[w].to_numpy(), equal_nan=True)]
        assert len(equal) == 1, (g, only_want)
        twins[g] = equal[0]
    assert sorted(twins.values()) == sorted(only_want)
    return twins


def test_grid_writes_the_reference_tables(screen):
    root, chains = screen
    want, got = chains["ref"]["grid"], chains["port"]["grid"]
    assert list(got) == list(want) == JOBS
    assert _files(root, "port_cp") == _files(root, "ref_cp")
    beyond = {}
    for (plate, t), files in want.items():
        assert sorted(got[(plate, t)]) == sorted(files) == ["Cells", "Cytoplasm", "Image", "Nuclei"]
        for name, path in files.items():
            ref, port = pd.read_csv(path), pd.read_csv(got[(plate, t)][name])
            assert list(port.columns) == list(ref.columns), name
            assert len(port) == len(ref) and (name != "Image" or len(ref) == 8)
            if name != "Image":
                assert len(ref) > 0
                np.testing.assert_array_equal(port["ObjectNumber"], ref["ObjectNumber"])
            for col in ref.columns:
                if not pd.api.types.is_numeric_dtype(ref[col]):
                    assert list(port[col]) == list(ref[col]), (name, col)
                    continue
                r, g = ref[col].to_numpy(np.float64), port[col].to_numpy(np.float64)
                bad = ~(np.abs(g - r) <= feature_tolerance(col, r, ref, SIZE, SIZE, 1e-10))
                bad &= ~(np.isnan(g) & np.isnan(r))
                if bad.any():
                    bound = next(v for k, v in PINNED_BOUND.items() if col.startswith(k))
                    assert np.abs(g - r)[bad].max() <= bound, (plate, t, name, col)
                    beyond[(plate, t, name, col)] = int(bad.sum())
    assert beyond == PINNED_GRID


@pytest.mark.parametrize("tail", list(TAILS))
def test_normalized_profiles_match_the_reference(screen, tail):
    root, chains = screen
    g_name, w_name = TAILS[tail]
    got, want = chains[g_name]["normalized"], chains[w_name]["normalized"]
    assert [os.path.relpath(p, os.path.join(root, f"{g_name}_normalized")) for p in got] == [
        os.path.relpath(p, os.path.join(root, f"{w_name}_normalized")) for p in want]
    for g, w in zip(got, want):
        rows, cols = assert_csv_close(g, w)
        assert rows == 8 and cols > 50, (g, rows, cols)


@pytest.mark.parametrize("tail", list(TAILS))
def test_selection_and_cosine_match_the_reference(screen, tail):
    root, chains = screen
    g_name, w_name = TAILS[tail]
    got, want = chains[g_name]["selected"], chains[w_name]["selected"]
    assert sorted(got) == sorted(want) == ["avg_cosine", "dsig", "raw"]
    assert _files(root, f"{g_name}_selected") == _files(root, f"{w_name}_selected")
    got_kept, want_kept = _kept(got["dsig"]), _kept(want["dsig"])
    assert len(got_kept) == len(want_kept) > 0
    twins = _twins(got_kept, want_kept, _normalized(chains[g_name]["normalized"]))
    for key in ("raw", "dsig"):
        g = pd.read_csv(got[key]).rename(columns=twins)
        w = pd.read_csv(want[key])
        assert sorted(g.columns) == sorted(w.columns)
        pd.testing.assert_frame_equal(g[list(w.columns)], w, rtol=1e-5, obj=got[key])
    rows, cols = assert_csv_close(got["avg_cosine"], want["avg_cosine"])
    assert rows > 0 and cols > 1


@pytest.mark.parametrize("tail", list(TAILS))
def test_hits_match_the_reference(screen, tail):
    root, chains = screen
    g_name, w_name = TAILS[tail]
    got, want = chains[g_name]["hits"], chains[w_name]["hits"]
    assert_csv_close(got["bioactivities"], want["bioactivities"])
    pd.testing.assert_frame_equal(got["ind_mean"][HIT_COLS], want["ind_mean"][HIT_COLS])
    assert got["thresholds"].keys() == want["thresholds"].keys()
    assert _files(root, f"{g_name}_hits") == _files(root, f"{w_name}_hits")
    assert len(want["plots"]) >= 3


def test_port_chain_calls_the_reference_hits(screen):
    root, chains = screen
    got, want = chains["port"], chains["ref"]
    for g, w in zip(got["normalized"], want["normalized"]):
        gn, wn = pd.read_csv(g), pd.read_csv(w)
        assert list(gn.columns) == list(wn.columns) and gn.shape == wn.shape
        meta = [c for c in wn.columns if "Metadata" in c]
        pd.testing.assert_frame_equal(gn[meta], wn[meta])
    assert len(_kept(got["selected"]["dsig"])) > 0
    pd.testing.assert_frame_equal(got["hits"]["ind_mean"][HIT_COLS], want["hits"]["ind_mean"][HIT_COLS])
    assert int(want["hits"]["ind_mean"]["Bioactive"].sum()) > 0
