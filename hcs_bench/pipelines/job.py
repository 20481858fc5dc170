"""A plate's feature extraction as the reference's fleet runs it: one
(plate, time) job at a time through ``run_feature_extraction_job``, which
reads the job's LoadData table and its sites' channels from TIFFs on disk,
segments and measures them in batches, and writes the four CellProfiler
CSVs (Image, Nuclei, Cells, Cytoplasm). The job is every site of the
traffic, the configuration's ``job_sites``, run again and again. The
TIFFs are written in set-up (``prepare``) with PIL, not with the program.
The check reads the sampled batch's rows back from the CSVs and holds
them, with the labels the job's segmenter returned, to
``pipelines/features.numbers``: the job reads each TIFF as float32, so the
reference measures the same float planes."""

from __future__ import annotations

import multiprocessing
import os
import shutil
import tempfile
import time
import warnings
import weakref
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import pandas as pd
import torch

from hcs_bench import program
from hcs_bench.pipelines import features

JOB = "saguaro_tpu_torch.pipeline.feature_extraction.run_feature_extraction_job"
TIMER = "saguaro_tpu_torch.utils.timing.StageTimer"
TABLES = ("Image", "Nuclei", "Cells", "Cytoplasm")


class JobFiles(list):
    """The traffic's batches (host numpy, as the generator made them), with
    their sites written to disk under ``root`` as one job: its LoadData CSV
    and images directory ``job``. The directory goes when the window ends,
    or with this object."""

    def __init__(self, batches: list, root: str, job: tuple[str, str]):
        super().__init__(batches)
        self.root, self.job = root, job
        self._cleanup = weakref.finalize(self, shutil.rmtree, root, True)

    def close(self) -> None:
        self._cleanup()


def well(i: int) -> str:
    """The i-th well of a 384-well plate, row by row: A01, A02, ..."""
    return f"{'ABCDEFGHIJKLMNOP'[i // 24]}{i % 24 + 1:02d}"


def write_job(root: str, name: str, plate: str, timepoint: str, sites: np.ndarray,
              channels: list) -> tuple[str, str]:
    """One job's input under ``root/<name>``: each site's channels as an LZW
    TIFF in ``Images/`` (``<well>_s1_<channel>.tiff``) and a LoadData CSV in
    the reference's columns. Returns (LoadData path, images directory)."""
    images = os.path.join(root, name, "Images")
    os.makedirs(images)
    rows, paths, planes = [], [], []
    for s, site in enumerate(sites):
        row = {"Metadata_Plate": plate, "Metadata_Well": well(s), "Metadata_Site": 1,
               "Metadata_Timepoint": timepoint}
        for c, ch in enumerate(channels):
            fname = f"{well(s)}_s1_{ch}.tiff"
            row[f"FileName_{ch}"], row[f"PathName_{ch}"] = fname, images
            paths.append(os.path.join(images, fname))
            planes.append(site[..., c])
        rows.append(row)
    write_tiffs(paths, planes)
    load_data = os.path.join(root, name, "load_data.csv")
    pd.DataFrame(rows).to_csv(load_data, index=False)
    return load_data, images


def write_tiffs(paths: list, planes: list) -> None:
    """Each plane to its path as an LZW TIFF, in up to 8 forked processes,
    all ended on return: PIL's encoder holds the GIL, so threads would
    write one at a time. The children only encode with PIL and exit,
    touching neither CUDA nor torch's threads, so the warning Python gives
    for forking a process that has threads is silenced here."""
    workers = min(8, os.cpu_count() or 1, len(paths))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("fork")) as pool:
            list(pool.map(_write_tiff, paths, planes, chunksize=max(1, len(paths) // (4 * workers))))


def _write_tiff(path: str, plane: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(np.ascontiguousarray(plane)).save(path, format="tiff", compression="tiff_lzw")


def prepare(cfg: dict, traffic: dict, batches: list) -> JobFiles:
    """Set-up: every site of the traffic written as the job's TIFFs and
    LoadData table, into a new temporary directory."""
    sites = np.concatenate(batches)
    if len(sites) != cfg["job_sites"]:
        raise ValueError(f"the traffic's {len(sites)} sites are not a job of {cfg['job_sites']}")
    root = tempfile.mkdtemp(prefix="hcs_bench_job_")
    job = write_job(root, "job", traffic["plate"], traffic["timepoint"], sites, list(cfg["channels"]))
    return JobFiles(batches, root, job)


class Segmenter:
    """The engine as the job's segmenter: ``segment_batch`` is the engine's,
    and the labels of its call number ``keep`` (counted from 0 within a job)
    are kept on the host in ``kept``."""

    def __init__(self, engine, keep: int | None = None):
        self.engine, self.keep, self.calls, self.kept = engine, keep, 0, None

    def segment(self, image):
        return self.engine.segment(image)

    def segment_batch(self, images):
        labels = self.engine.segment_batch(images)
        if self.calls == self.keep:
            self.kept = torch.stack(list(labels)).cpu().numpy()
        self.calls += 1
        return labels


def run_job(engine, cfg: dict, files: tuple[str, str], out: str, segmenter: Segmenter, site_batch: int,
            timer=None) -> dict:
    """One job through the program: its LoadData table read from disk, then
    ``run_feature_extraction_job`` into ``out`` (its CSVs overwritten)."""
    load_data, images = files
    return program.resolve(JOB)(pd.read_csv(load_data), images, out, list(cfg["channels"]), segmenter,
                                program.feature_config(cfg), site_batch=site_batch,
                                device=engine.device, timer=timer)


def nuclei_sites(path: str) -> set[int]:
    """The ImageNumbers that have rows in a Nuclei CSV, read from its
    ImageNumber column alone."""
    with open(path) as f:
        head = f.readline().rstrip("\n").split(",")
        if "ImageNumber" not in head:
            return set()
        i = head.index("ImageNumber")
        return {int(float(line.split(",", i + 1)[i])) for line in f if line.strip()}


def _read(path: str) -> pd.DataFrame | None:
    """A CSV as text (None where the file is missing, no columns where it
    is empty)."""
    if not os.path.exists(path):
        return None
    try:
        return pd.read_csv(path, dtype=str)
    except pd.errors.EmptyDataError:
        return pd.DataFrame()


def as_written(text: pd.Series) -> pd.Series:
    """A CSV column's text as the numbers pandas wrote: a float32 column is
    written as each value's shortest float32 form, which reads back into
    float64 as another number, so a column whose every finite value is that
    form reads as float32; any other column as float64, and a column that
    is not all numbers stays text."""
    x = pd.to_numeric(text, errors="coerce")
    if (x.isna() & text.notna()).any():
        return text
    v = x.to_numpy(np.float64)
    v32 = v.astype(np.float32)
    fin = np.isfinite(v)
    if fin.any() and (v32[fin].astype(str) == text.to_numpy()[fin].astype(str)).all():
        v = v32.astype(np.float64)
    return pd.Series(v, index=text.index, name=text.name)


def site_tables(out: str, first: int, n: int) -> list:
    """The rows of sites ``first + 1`` to ``first + n`` of a job's CSVs, a
    {table: DataFrame} a site, each column at the precision it was written
    (``as_written``) and the ImageNumber counted from 1 (None for a site
    with no Image row)."""
    frames = {}
    for name in TABLES:
        df = _read(os.path.join(out, f"{name}.csv"))
        if df is not None and "ImageNumber" in df:
            num = pd.to_numeric(df["ImageNumber"])
            df = df[(num > first) & (num <= first + n)]
            df = pd.DataFrame({c: as_written(df[c]) for c in df.columns})
            df["ImageNumber"] -= first
        frames[name] = df
    image = frames["Image"]
    have = set() if image is None or "ImageNumber" not in image else set(image["ImageNumber"].tolist())
    sites = []
    for num in range(1, n + 1):
        if num not in have:
            sites.append(None)
            continue
        site = {}
        for name, df in frames.items():
            if df is not None:
                rows = df[df["ImageNumber"] == num] if "ImageNumber" in df else df.iloc[0:0]
                site[name] = rows.reset_index(drop=True)
        sites.append(site)
    return sites


def window(engine, cfg: dict, batches: JobFiles, seconds: float, sample_k: int, synced: bool,
           after_batch=None, recording: bool = True) -> program.Window:
    """Closed loop of the job: each run writes its CSVs over the previous
    run's, and its sites count once it returns (its CSVs written); a site
    with no Nuclei row has failed. Runs go on until ``seconds`` have passed
    (and the sampled batch ``sample_k``, counted over the window's batches,
    has run); the window closes when the run in flight has written its
    CSVs. The sampled run writes into a directory of its own, read back
    after the window closes; then the whole directory goes.
    ``Window.batches`` counts runs. Spans: ``job`` around each run (synced
    with ``synced``), and ``job.<stage>``, the job's own ``StageTimer``
    stages (``read``, ``segment``, ``dispatch``, ``finalize``, ``write``)."""
    stage_timer = program.resolve(TIMER)
    n, sites = len(batches[0]), sum(len(b) for b in batches)
    sample_job, half = divmod(sample_k, len(batches))
    w = program.Window(sample_batch=sample_k, recording=recording)
    span = program.Spans(w, engine.device, synced)
    out, sample_out = (os.path.join(batches.root, "out", d) for d in ("job", "sample"))
    seg = Segmenter(engine)
    try:
        w.t_start = w.t_clock = w.span_t0 = time.perf_counter()
        r = 0
        while True:
            kept = w.recording
            seg.calls, seg.keep = 0, half if r == sample_job else None
            timer = stage_timer()
            written = span("job", run_job, engine, cfg, batches.job, sample_out if r == sample_job else out,
                           seg, n, timer)
            have = nuclei_sites(written["Nuclei"]) if set(written) >= set(TABLES) else set()
            w.sites += sites
            w.span_sites += sites if kept else 0
            w.failed += sites - len(have & set(range(1, sites + 1)))
            for stage, s in timer.total.items():
                w.add_span(f"job.{stage}", s)
            w.batches += 1
            w.batch_ends.append(time.perf_counter())
            if r == sample_job:
                w.sample_input, w.sample_labels = half, seg.kept
            if after_batch is not None:
                after_batch(w)
            r += 1
            if time.perf_counter() - w.t_clock >= seconds and r > sample_job:
                break
        w.t_end = time.perf_counter()
        w.sample_outputs = site_tables(sample_out, half * n, n)
    finally:
        batches.close()
    return w


def batch(engine, cfg: dict, images: np.ndarray) -> tuple[np.ndarray, list]:
    """One batch as a job of its own, from its TIFFs written into a
    temporary directory. Returns (its labels, its rows read back from the
    CSVs, a site)."""
    with tempfile.TemporaryDirectory(prefix="hcs_bench_job_") as root:
        files = write_job(root, "job", "P1", "0", images, list(cfg["channels"]))
        seg = Segmenter(engine, keep=0)
        out = os.path.join(root, "out")
        run_job(engine, cfg, files, out, seg, len(images))
        return seg.kept, site_tables(out, 0, len(images))


def numbers(cfg: dict, images: np.ndarray, judged_labels: np.ndarray, judged, ref, seed: int,
            ref_labels: np.ndarray, control=None, detail: dict | None = None) -> dict[str, float]:
    """``pipelines/features.numbers`` over the planes as the job measured
    them: each TIFF read as float32."""
    return features.numbers(cfg, np.asarray(images, np.float32), judged_labels, judged, ref, seed,
                            ref_labels, control, detail)
