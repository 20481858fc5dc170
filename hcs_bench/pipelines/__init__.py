"""The pipelines a configuration runs, one module a pipeline,
``pipelines/<name>.py``, found by the configuration's ``"pipeline"``. A new
pipeline is a new module here; it reaches the program only through
``program.py`` and imports nothing of the program itself. Each supplies:

- ``window(engine, cfg, batches, seconds, sample_k, synced, after_batch=None,
  recording=True) -> program.Window``: the closed loop the run measures,
  with the sampled batch's labels and outputs kept for the check; the cell's
  rate is ``<pipeline>_sites_per_s``, the window's sites over its seconds.
- ``batch(engine, cfg, images) -> (labels, outputs)``: one batch through
  the calls the window makes (the warm batch, and the calibration's).
- ``numbers(cfg, images, labels, outputs, ref, seed, ref_labels,
  control=None, detail=None) -> dict``: the check's numbers beyond
  ``labels_px_off`` (``compare.numbers``), each with its limit in
  ``limits/<cell>.json``.

A pipeline may also supply ``prepare(cfg, traffic, batches) -> batches``:
set-up that its window needs beyond the batches in memory (``job``: the
sites written to disk), run before the engine is built; what it returns
goes to the warm batch and the window in their place."""

from __future__ import annotations

import importlib


def load(name: str):
    """The module of the pipeline named ``name``."""
    return importlib.import_module(f"{__name__}.{name}")
